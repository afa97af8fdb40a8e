"""bf16-vs-f32 BD-rate gate on a trained checkpoint: the port's
counterpart of the JAX package's tools/bf16_bd_gate.py.

Sweeps rate anchors through the REAL codec engine (codec/engine
.VideoCodec.compress: staged device programs, host rANS, container
streams) three times — f32 parameters, bf16-cast parameters
(utils/precision.cast_params) and the mixed policy
(utils/precision.cast_params_mixed: bf16 with the reconstruction path
kept f32) — and computes BD-rate (eval/bd_metrics.bd_rate) of each
against f32 from (container bits per pixel, recon PSNR against the
source frame). Streams stay decodable bit-exactly in every mode by
construction (the engine runs the decoder's stage programs inside the
encoder); the question is how much rate/quality the bf16 operating point
costs.

Prints one JSON line with the curves and the BD-rates (the JAX tool's
keys). Gate: bf16 is neutral iff the curves span at least 0.5 dB
(bd_valid) and |BD-rate| < 1 %. This tool only reports the figure.

Usage:
  python -m vcm_ts_tpu_torch.bf16_bd_gate \
      --ckpt artifacts/overfit/overfit_final.pth \
      [--size 256] [--frames 2] [--anchors ...] [--device cuda]

--ckpt is a .pth (a DMC state_dict, as overfit_run writes) or a port
checkpoint .pt (utils/weights.read_state_dict); a JAX .ckpt raises and
names the way across. The clip is overfit_run's synthetic moving clip
(in-distribution content for the overfit checkpoint). Runs on cuda by
default and raises without a card; --device cpu runs on the CPU.
"""

from __future__ import annotations

import argparse
import copy
import json

import numpy as np
import torch

from .codec.engine import VideoCodec
from .eval.bd_metrics import bd_rate
from .models.dmc import DMC, make_dpb
from .overfit_run import make_synthetic_batch
from .utils.device import resolve_device
from .utils.precision import cast_params, cast_params_mixed
from .utils.weights import read_state_dict


def load_dmc(path: str, channels, anchor_num: int, device) -> DMC:
    """A DMC of the given widths holding the file's weights; every
    parameter and buffer must be in the file."""
    cmv, cn, cm = channels
    model = DMC(anchor_num=anchor_num, channel_mv=cmv, channel_N=cn,
                channel_M=cm, device=device)
    missing, _ = model.load_state_dict(read_state_dict(path), strict=False)
    if missing:
        raise KeyError(f"{path} does not cover the DMC: {missing[:10]}")
    return model.eval()


def sweep(model, dtype, ref, xs, anchors, device) -> np.ndarray:
    """(bpp, psnr) per anchor: a chain of P-frames off the source's first
    frame, each coded to a stream, its bits counted and its decoder-exact
    recon scored against the source."""
    codec = VideoCodec(model, device=device)
    codec.update()
    cn, cm = model.channel_N, model.channel_M
    n_pix = xs[0].shape[1] * xs[0].shape[2] * len(xs)
    pts = []
    for mv_q, y_q in anchors:
        dpb = make_dpb(torch.from_numpy(ref).to(device, dtype), cn, cm)
        bits, mses = 0, []
        for t, x in enumerate(xs):
            out = codec.compress(torch.from_numpy(x).to(device, dtype), dpb,
                                 mv_q, y_q, is_first_p=(t == 0))
            dpb = out["dpb"]
            bits += len(out["bit_stream"]) * 8
            rec = dpb["ref_frame"].float().cpu().numpy()
            mses.append(np.mean((rec - x) ** 2))
        pts.append((bits / n_pix,
                    -10.0 * np.log10(np.mean(mses) + 1e-12)))
    return np.asarray(pts)


def gate(args) -> dict:
    device = resolve_device(args.device)
    model = load_dmc(args.ckpt, args.channels, args.anchor_num, device)

    seq = make_synthetic_batch(1, args.frames + 1, args.size)[0]
    ref, xs = seq[0:1], [seq[t:t + 1] for t in range(1, args.frames + 1)]
    anchors = [tuple(float(v) for v in a.split(":"))
               for a in args.anchors.split(",")]

    f32_pts = sweep(model, torch.float32, ref, xs, anchors, device)
    bf16_pts = sweep(cast_params(copy.deepcopy(model), torch.bfloat16),
                     torch.bfloat16, ref, xs, anchors, device)
    # third operating point: bf16 with the reconstruction path kept f32 —
    # the candidate fix if wholesale bf16 fails
    mixed_pts = sweep(cast_params_mixed(copy.deepcopy(model)),
                      torch.bfloat16, ref, xs, anchors, device)

    bd = bd_rate(f32_pts[:, 0], f32_pts[:, 1], bf16_pts[:, 0],
                 bf16_pts[:, 1])
    bd_mixed = bd_rate(f32_pts[:, 0], f32_pts[:, 1], mixed_pts[:, 0],
                       mixed_pts[:, 1])
    return report(args, f32_pts, bf16_pts, mixed_pts, bd, bd_mixed)


def report(args, f32_pts, bf16_pts, mixed_pts, bd, bd_mixed) -> dict:
    """The JSON line's dict. BD needs a real quality span to integrate
    over: a curve spanning under 0.5 dB flags bd_valid false."""
    span = min(f32_pts[:, 1].max() - f32_pts[:, 1].min(),
               bf16_pts[:, 1].max() - bf16_pts[:, 1].min())
    valid = bool(span >= 0.5)
    return {
        "metric": f"BD-rate bf16-vs-f32 on {args.ckpt} "
                  f"({args.frames} P-frames, {args.size}x{args.size})",
        "bd_rate_pct": round(float(bd), 4),
        "f32_bpp": [round(float(v), 6) for v in f32_pts[:, 0]],
        "f32_psnr": [round(float(v), 4) for v in f32_pts[:, 1]],
        "bf16_bpp": [round(float(v), 6) for v in bf16_pts[:, 0]],
        "bf16_psnr": [round(float(v), 4) for v in bf16_pts[:, 1]],
        "mixed_bpp": [round(float(v), 6) for v in mixed_pts[:, 0]],
        "mixed_psnr": [round(float(v), 4) for v in mixed_pts[:, 1]],
        "bd_rate_mixed_pct": round(float(bd_mixed), 4),
        "gate": "bf16 stays bench default iff |BD| < 1%; else promote "
                "mixed if IT is <1%",
        "psnr_span_db": round(float(span), 4),
        "bd_valid": valid,
        "bf16_neutral": bool(valid and abs(bd) < 1.0),
        "mixed_neutral": bool(valid and abs(bd_mixed) < 1.0),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--channels", type=int, nargs=3, default=[64, 64, 96],
                    help="channel_mv channel_N channel_M of the checkpoint")
    ap.add_argument("--anchor-num", type=int, default=4)
    ap.add_argument("--anchors", default="0.6:0.7,0.8:1.0,1.0:1.2,1.2:1.5")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    out = gate(parse_args(argv))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
