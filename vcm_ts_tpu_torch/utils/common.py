"""Rate-point interpolation, the CLI's yes/no flag type, the per-sequence
metric log and its fixed-precision JSON writer (the port's copy of
vcm_ts_tpu/utils/common.py: the same JSON text, key for key and digit for
digit, so bd_rate and benchmark_plot read logs of either package)."""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

_TRUE = frozenset(("yes", "true", "t", "y", "1"))
_FALSE = frozenset(("no", "false", "f", "n", "0"))


def str2bool(v) -> bool:
    """argparse type for explicit yes/no flags."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def interpolate_log(min_val: float, max_val: float, num: int,
                    descending: bool = True) -> np.ndarray:
    """`num` points geometrically spaced over [min_val, max_val]: the rate
    ladder between a checkpoint's trained q-scale anchors."""
    if not (0 < min_val < max_val):
        raise ValueError(f"need 0 < min_val < max_val, got "
                         f"[{min_val}, {max_val}]")
    pts = np.geomspace(min_val, max_val, num)
    return pts[::-1].copy() if descending else pts


def scale_list_to_str(scales) -> str:
    return "".join(f"{s:.2f} " for s in scales)


def create_folder(path, print_if_create: bool = False) -> None:
    existed = os.path.isdir(path)
    os.makedirs(path, exist_ok=True)
    if print_if_create and not existed:
        print(f"created folder: {path}")


def _round_floats(obj, digits: int):
    """Round every float in a JSON-ish tree."""
    if isinstance(obj, float):
        return round(obj, digits)
    if isinstance(obj, dict):
        return {k: _round_floats(v, digits) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_round_floats(v, digits) for v in obj]
    return obj


def dump_json(obj, fid, float_digits: int = -1, **kwargs) -> None:
    """json.dump with optional fixed float precision."""
    if float_digits >= 0:
        obj = _round_floats(obj, float_digits)
    json.dump(obj, fid, **kwargs)


def generate_log_json(frame_num, frame_types, bits, psnrs, ssims,
                      frame_pixel_num, decoded=None):
    """Per-sequence metric JSON: the reference schema (key names and I/P
    aggregation rules) that benchmark_plot and bd_rate read."""
    types = np.asarray(frame_types[:frame_num])
    bits_a = np.asarray(bits[:frame_num], dtype=np.float64)
    psnr_a = np.asarray(psnrs[:frame_num], dtype=np.float64)
    ssim_a = np.asarray(ssims[:frame_num], dtype=np.float64)
    is_i = types == 0
    i_num = int(is_i.sum())
    p_num = frame_num - i_num

    def _avg(arr, mask, n):
        return float(arr[mask].sum() / n) if n else 0

    return {
        "frame_pixel_num": frame_pixel_num,
        "i_frame_num": i_num,
        "p_frame_num": p_num,
        "ave_i_frame_bpp": _avg(bits_a, is_i, i_num) / frame_pixel_num,
        "ave_i_frame_psnr": _avg(psnr_a, is_i, i_num),
        "ave_i_frame_msssim": _avg(ssim_a, is_i, i_num),
        "frame_bpp": list(bits_a / frame_pixel_num),
        "frame_psnr": psnrs,
        "frame_msssim": ssims,
        "frame_type": frame_types,
        "ave_p_frame_bpp": (_avg(bits_a, ~is_i, p_num) / frame_pixel_num
                            if p_num else 0),
        "ave_p_frame_psnr": _avg(psnr_a, ~is_i, p_num),
        "ave_p_frame_msssim": _avg(ssim_a, ~is_i, p_num),
        "ave_all_frame_bpp": float(bits_a.sum()) / (frame_num
                                                    * frame_pixel_num),
        "ave_all_frame_psnr": float(psnr_a.sum()) / frame_num,
        "ave_all_frame_msssim": float(ssim_a.sum()) / frame_num,
        "decoded": decoded,
    }


def enable_debug_nans(enable: bool = True) -> None:
    """NaN sanitizer for training runs (cfg.SOLVER.DEBUG_NANS): autograd's
    anomaly mode, which raises at the backward op that produced a NaN and
    names the forward op behind it. Debug only: it slows every step."""
    import torch

    torch.autograd.set_detect_anomaly(bool(enable))
