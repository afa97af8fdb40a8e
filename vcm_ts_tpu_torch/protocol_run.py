"""Reference-protocol-scale evaluation run: the port's counterpart of the
JAX package's tools/protocol_run.py.

The reference's harness sweeps 96-frame sequences at GOP 32 over 4 rate
points with real bitstreams (DCVC_HEM/test_video.py:80-182,
dataset_config_example.json). This tool runs the port's harness
(test_video.main, in this process) at exactly that protocol on a
generated 1080p clip: 96 frames, intra period 32 (3 GOPs, so two
re-keys), 4 rate points, real container .bin streams, PSNR / MS-SSIM per
frame and the generate_log_json output. 1080 is not a multiple of 64, so
the harness's padding path runs too.

The clip is synthetic: a textured scene under global translation and a
moving occluder, giving the motion path real work and P-frames real
references. gen_sequence draws it as the JAX tool does with numpy alone:
cv2.resize(..., INTER_CUBIC) of its float64 noise grids becomes
resize_cubic_f64 (cv2's float path: A = -0.75, f32 taps, replicated
border), and cv2.imwrite's BGR order becomes a channel-reversed PNG
(codec/png_io.py), so the files decode to the JAX tool's pixels.

Every run then decodes each rate point's .bin chain again with fresh
codecs, as a decoder that has only the files would, and exits non-zero
unless each P-frame equals the encoder's recon and each I-frame the
harness's decode (by digest). The summary line gives the kernel launches
of each rate point's coding (ops/cuda_build.LAUNCHES; zero on the CPU);
OUT/frames.json keeps the harness's per-frame records (type, recon digest,
launches), rate points in order.

    python -m vcm_ts_tpu_torch.protocol_run --out artifacts/protocol \
        [--model-path overfit_final.pth] [--i-frame-model-path I.pth] \
        [--frames 96] [--gop 32] [--rate-num 4] [--size 1080x1920] \
        [--seq-root DIR] [--device cuda]

Runs on cuda by default and raises without a card; --device cpu runs on
the CPU. Without --model-path the harness's seeded weights code the
clip.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from . import test_video
from .codec import bitstream as bs
from .codec.png_io import write_png
from .models.dmc import make_dpb


def _cubic_taps_f32(ssize: int, dsize: int):
    """(dsize, 4) source indexes (replicated at the borders) and f32
    weights of cv::resize's INTER_CUBIC along one axis."""
    scale = 1.0 / (dsize / ssize)
    a = np.float32(-0.75)
    idx = np.zeros((dsize, 4), np.int64)
    wts = np.zeros((dsize, 4), np.float32)
    for d in range(dsize):
        fx = float(np.float32((d + 0.5) * scale - 0.5))
        sx = math.floor(fx)
        x = np.float32(fx - sx)
        c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
        c1 = ((a + 2) * x - (a + 3)) * x * x + 1
        c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
        wts[d] = (c0, c1, c2, np.float32(1) - c0 - c1 - c2)
        idx[d] = np.clip(np.arange(sx - 1, sx + 3), 0, ssize - 1)
    return idx, wts


def resize_cubic_f64(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """(H, W, C) float64 -> (dh, dw, C) float64, as cv2.resize(img, (dw,
    dh), interpolation=cv2.INTER_CUBIC): a horizontal then a vertical
    pass, each the four taps' products (f32 weights, f64 values) summed
    in order."""
    img = np.asarray(img, np.float64)
    h, w = img.shape[:2]
    xi, xw = _cubic_taps_f32(w, dw)
    xw = xw.astype(np.float64)
    rows = img[:, xi[:, 0]] * xw[:, 0, None]
    for k in range(1, 4):
        rows = rows + img[:, xi[:, k]] * xw[:, k, None]
    yi, yw = _cubic_taps_f32(h, dh)
    yw = yw.astype(np.float64)
    out = rows[yi[:, 0]] * yw[:, 0, None, None]
    for k in range(1, 4):
        out = out + rows[yi[:, k]] * yw[:, k, None, None]
    return out


def gen_sequence(root: str, n_frames: int, h: int, w: int, seed: int = 0):
    """n_frames PNG frames: textured background translating + moving
    occluder (the JAX tool's draws and pixels)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    # textured base, band-limited so flows are trackable: upsampled noise
    # octaves at 3 scales
    big_h, big_w = h + 256, w + 256
    base = np.zeros((big_h, big_w, 3), np.float32)
    for cell, amp in ((64, 0.5), (16, 0.3), (4, 0.2)):
        g = rng.random((big_h // cell + 2, big_w // cell + 2, 3))
        up = resize_cubic_f64(g, big_w, big_h)
        base += amp * up
    base = (base / base.max() * 255).astype(np.uint8)
    oh, ow = max(16, h // 7), max(16, w // 8)  # occluder ~1.5% of frame
    occ = (rng.random((oh, ow, 3)) * 255).astype(np.uint8)
    for t in range(n_frames):
        ox = int(40 + 1.3 * t)     # global pan
        oy = int(30 + 0.6 * t)
        frame = base[oy:oy + h, ox:ox + w].copy()
        # occluder moves opposite the pan
        px = int(w - ow - 60 - 2.0 * t) % (w - ow)
        py = int(oh + 1.1 * t) % (h - oh)
        frame[py:py + oh, px:px + ow] = occ
        # cv2.imwrite reads the array as BGR: the PNG holds it reversed
        write_png(os.path.join(root, f"im{t + 1:05d}.png"),
                  np.ascontiguousarray(frame[:, :, ::-1]))
    return n_frames


def decode_streams(argv_tv, bin_root: str, n_frames: int, gop: int,
                   rate_num: int, h: int, w: int) -> list:
    """Every rate point's .bin chain decoded by fresh codecs (the harness's
    weights), as a decoder that has only the files would: per rate point,
    the digest of each frame's recon before the clamp (an I-frame's decode,
    a P-frame's DPB frame) in frame order."""
    i_codec, video_codec = test_video.build_codecs(
        test_video.parse_args(argv_tv))
    out = []
    for rate in range(rate_num):
        dpb, is_first_p, digests = None, True, []
        out.append(digests)
        for t in range(n_frames):
            path = os.path.join(bin_root, str(rate), f"{t}.bin")
            if t % gop == 0:
                height, width, q_index, stream = bs.decode_i(path)
                x_hat = i_codec.decompress(stream, height, width,
                                           q_index / 100)
                digests.append(test_video.digest(x_hat))
                dpb = make_dpb(torch.clamp(x_hat, 0, 1),
                               video_codec.model.channel_N,
                               video_codec.model.channel_M)
                is_first_p = True
            else:
                mv_index, y_index, stream = bs.decode_p(path)
                dpb = video_codec.decompress(dpb, stream, h, w,
                                             mv_index / 100, y_index / 100,
                                             is_first_p)["dpb"]
                digests.append(test_video.digest(dpb["ref_frame"]))
                dpb["ref_frame"] = torch.clamp(dpb["ref_frame"], 0, 1)
                is_first_p = False
    return out


def check_streams(decoded: list, coded: list) -> int:
    """Exits unless every rate point's decoded digests equal the harness's
    per-frame records (test_video.run_test's `frames`); returns the number
    of frames checked."""
    bad = [(rate, t) for rate, (d, c) in enumerate(zip(decoded, coded))
           for t, (x, f) in enumerate(zip(d, c)) if x != f["recon_sha256"]]
    if bad or [len(d) for d in decoded] != [len(c) for c in coded]:
        raise SystemExit(f"protocol_run: the streams' decode differs from "
                         f"the encoder's recon at (rate point, frame) {bad}")
    return sum(len(d) for d in decoded)


def launch_summary(coded: list) -> dict:
    """The kernel launches of each rate point's coding, and their mean per
    I- and per P-frame, from the harness's per-frame records."""
    per_rate = [{k: sum(f["launches"][k] for f in rate)
                 for k in rate[0]["launches"]} for rate in coded]
    per_frame = {}
    for kind, typ in (("i", 0), ("p", 1)):
        fs = [f["launches"] for rate in coded for f in rate
              if f["type"] == typ]
        if fs:
            per_frame[kind] = {k: float(np.mean([n[k] for n in fs]))
                               for k in fs[0]}
    return {"launches_per_rate_point": per_rate,
            "launches_per_frame": per_frame}


def rd_lines(log: dict) -> list[str]:
    """One RD recap line per rate point (generate_log_json schema)."""
    lines = []

    def walk(node, path=""):
        if isinstance(node, dict):
            if "ave_all_frame_bpp" in node:
                lines.append(
                    f"{path}: bpp={node['ave_all_frame_bpp']:.4f} "
                    f"psnr={node.get('ave_all_frame_psnr', 0):.3f} "
                    f"msssim={node.get('ave_all_frame_msssim', 0):.4f}")
                return
            for k, v in node.items():
                walk(v, f"{path}/{k}")

    walk(log)
    return lines


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="artifacts/protocol")
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--gop", type=int, default=32)
    ap.add_argument("--rate-num", type=int, default=4)
    ap.add_argument("--size", default="1080x1920")
    ap.add_argument("--model-path", default=None,
                    help=".pth DMC weights (e.g. overfit_run's "
                         "overfit_final.pth); default the seeded init")
    ap.add_argument("--i-frame-model-path", default=None)
    ap.add_argument("--seq-root", default=None,
                    help="reuse an existing PNG sequence dir")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    h, w = (int(v) for v in a.size.split("x"))
    os.makedirs(a.out, exist_ok=True)
    seq_name = f"Synthetic_{w}x{h}_30"
    if a.seq_root:
        seq_dir = os.path.join(a.seq_root, "Synthetic", seq_name)
    else:
        seq_dir = os.path.join(a.out, "seq", "Synthetic", seq_name)
        print(f"generating {a.frames} frames at {w}x{h} ...", flush=True)
        gen_sequence(seq_dir, a.frames, h, w)
    root_path = os.path.dirname(os.path.dirname(seq_dir))

    cfg = {
        "root_path": root_path,
        "test_classes": {
            "Synthetic": {
                "test": 1,
                "base_path": "Synthetic",
                "src_type": "png",
                "sequences": {
                    seq_name: {"width": w, "height": h,
                               "frames": a.frames, "gop": a.gop},
                },
            },
        },
    }
    cfg_path = os.path.join(a.out, "dataset_config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)

    out_json = os.path.join(a.out, "protocol_log.json")
    argv_tv = ["--test_config", cfg_path,
               "--rate_num", str(a.rate_num),
               "--write_stream", "True",
               "--stream_path", os.path.join(a.out, "bins"),
               "--output_path", out_json,
               "--verbose", "1",
               "--device", a.device]
    if a.model_path:
        argv_tv += ["--model_path", a.model_path]
    if a.i_frame_model_path:
        argv_tv += ["--i_frame_model_path", a.i_frame_model_path]
    print("running: python -m vcm_ts_tpu_torch.test_video",
          " ".join(argv_tv), flush=True)
    t0 = time.time()
    frames = {}
    log = test_video.main(argv_tv, frames=frames)
    dt = time.time() - t0
    fps = a.frames * a.rate_num / dt
    coded = [frames[("Synthetic", seq_name, r)] for r in range(a.rate_num)]
    with open(os.path.join(a.out, "frames.json"), "w") as f:
        json.dump(coded, f)
    summary = {"wall_s": round(dt, 1),
               "frames_total": a.frames * a.rate_num,
               "aggregate_fps": round(fps, 3),
               "log": out_json,
               **launch_summary(coded)}
    t0 = time.time()
    decoded = decode_streams(argv_tv, os.path.join(a.out, "bins", seq_name),
                             a.frames, a.gop, a.rate_num, h, w)
    summary["decoded_equal_frames"] = check_streams(decoded, coded)
    summary["decode_check_s"] = round(time.time() - t0, 1)
    with open(os.path.join(a.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    for line in rd_lines(log):
        print(line)
    return summary


if __name__ == "__main__":
    main()
