"""Rate-point interpolation and the CLI's yes/no flag type (the port's
copy of `str2bool` and `interpolate_log`, vcm_ts_tpu/utils/common.py)."""

from __future__ import annotations

import argparse

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
