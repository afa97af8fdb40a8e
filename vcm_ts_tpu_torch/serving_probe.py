"""Diagnostics of the serving paths: which ops give a batch row other bits
than the row alone, and how concurrent sessions scale.

    python -m vcm_ts_tpu_torch.serving_probe [--size 1088x1920] [--device cuda]

1. Batch invariance. During compress_batch at N = 2 (and the DMC's
   decompress_batch), every module of IntraNoAR and DMC, in f32 with the
   exact warp and in bf16 with fast_warp, is run again on row 0 of its
   input and compared bit for bit with row 0 of its output. Printed: the
   module kinds that differ, first with ops/rowwise.py as shipped, then
   with its ops taking the whole batch at once (what it guards against).
2. The SE layers' channel means as one reduction at N = 2 against one row
   at a time, at the UNet's shapes.
3. Sessions: aggregate fps of 1 and 2 concurrent encode_gop / decode_gop
   sessions (bf16, fast_warp, 4 P-frames each) through one codec, each in
   a new thread: cold (no warm-up in that thread) and warm (the same call
   first, as run_sessions' warmup), the warm ones at the interpreter's
   default thread switch interval and at 0.5 ms.

Seeded random weights and frames (utils/weights.py). The last line of
standard output is one JSON object with every number printed above it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .codec.engine import IntraCodec, VideoCodec, run_sessions
from .models.dmc import make_dpb
from .ops import rowwise
from .utils.device import resolve_device, set_codec_numerics
from .utils.precision import cast_params
from .utils.weights import make_dmc, make_intra

PER_ROW = rowwise.per_row  # as shipped


def variant_modules(model, run) -> dict:
    """Run `run()`; every module called on an N = 2 input is called again
    on row 0 and compared. Returns {"Kind CxHxW dtype": max abs diff}."""
    busy, found = [False], {}

    def hook(mod, args, out):
        first = next((a for a in args if torch.is_tensor(a)), None)
        if busy[0] or first is None or first.shape[0] != 2:
            return
        busy[0] = True
        try:
            alone = mod(*[a[:1] if torch.is_tensor(a) and a.shape[0] == 2
                          else a for a in args])
        finally:
            busy[0] = False
        outs = out if isinstance(out, (tuple, list)) else [out]
        alone = alone if isinstance(alone, (tuple, list)) else [alone]
        for a, b in zip(outs, alone):
            if torch.is_tensor(a) and not torch.equal(a[:1], b):
                key = (f"{type(mod).__name__} "
                       f"{'x'.join(map(str, first.shape[1:]))} "
                       f"{str(first.dtype)[6:]}")
                diff = float((a[:1].float() - b.float()).abs().max())
                found[key] = max(found.get(key, 0.0), diff)
                return

    handles = [m.register_forward_hook(hook) for _, m in
               model.named_modules() if _]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in handles:
            h.remove()
    return found


def whole_batch(fn, x, *args):
    """rowwise.per_row's stand-in for part 1: the op on the whole batch."""
    return fn(x, *args)


def probe_batches(device, h, w, g) -> dict:
    out = {}
    xs = [torch.rand((2, h, w, 3), device=device, generator=g)
          for _ in range(2)]
    q = torch.tensor([0.5, 0.3]).reshape(2, 1, 1, 1)
    for tag in ("f32", "bf16_fast_warp"):
        if tag == "f32":
            mi, md = make_intra(device), make_dmc(device)
        else:
            mi = cast_params(make_intra(device), torch.bfloat16)
            md = cast_params(make_dmc(device, fast_warp=True), torch.bfloat16)
        ic, vc = IntraCodec(mi, device=device), VideoCodec(md, device=device)
        ic.update()
        vc.update()
        dpb = make_dpb(ic.decompress_batch(ic.compress_batch(xs[0], q), h, w,
                                           q))
        streams = vc.compress_batch(xs[1], dpb, q, q, True)["bit_streams"]
        for mode in ("row by row", "whole batch"):
            if mode == "whole batch":
                rowwise.per_row = whole_batch
            try:
                res = {
                    "intra compress": variant_modules(
                        mi, lambda: ic.compress_batch(xs[0], q)),
                    "dmc compress": variant_modules(
                        md, lambda: vc.compress_batch(xs[1], dpb, q, q,
                                                      True)),
                    "dmc decompress": variant_modules(
                        md, lambda: vc.decompress_batch(dpb, streams, h, w,
                                                        q, q, True))}
            finally:
                rowwise.per_row = PER_ROW
            out[f"{tag}, {mode}"] = res
            for path, found in res.items():
                print(f"[batch {tag}, {mode}] {path}: {len(found)} module "
                      "kinds differ" + "".join(
                          f"\n    {k}: {v:.3g}" for k, v in
                          sorted(found.items(), key=lambda kv: -kv[1])),
                      flush=True)
    return out


def probe_means(device, h, w, g) -> dict:
    out = {}
    for c, hh, ww in ((16, h, w), (32, h, w), (64, h // 2, w // 2),
                      (128, h // 4, w // 4)):
        x = torch.randn((2, c, hh, ww), device=device, generator=g).to(
            memory_format=torch.channels_last)
        both = x.mean(dim=(2, 3), dtype=torch.float32)
        rows = torch.cat([x[i:i + 1].mean(dim=(2, 3), dtype=torch.float32)
                          for i in range(2)])
        diff = float((both - rows).abs().max())
        out[f"{c}x{hh}x{ww}"] = diff
        print(f"[mean] SE mean at {c}x{hh}x{ww} f32: N = 2 against rows, "
              f"max abs diff {diff:.3g}", flush=True)
    return out


def probe_sessions(device, h, w, g, n_p=4) -> dict:
    mi = cast_params(make_intra(device), torch.bfloat16)
    md = cast_params(make_dmc(device, fast_warp=True), torch.bfloat16)
    ic, vc = IntraCodec(mi, device=device), VideoCodec(md, device=device)
    ic.update()
    vc.update()
    x = [torch.rand((1, h, w, 3), device=device, generator=g)
         for _ in range(n_p + 1)]
    dpb = make_dpb(ic.decompress(ic.compress(x[0], 0.5), h, w, 0.5))
    streams, _ = vc.encode_gop(x[1:], dpb, 0.7, 0.7)
    vc.decode_gop(dpb, streams, h, w, 0.7, 0.7)  # warm
    runs = {"encode_gop": lambda: vc.encode_gop(x[1:], dpb, 0.7, 0.7),
            "decode_gop": lambda: vc.decode_gop(dpb, streams, h, w, 0.7,
                                                0.7)}
    default = sys.getswitchinterval()
    out = {}
    try:
        for warm, interval in ((False, default), (True, default),
                               (True, 0.0005)):
            sys.setswitchinterval(interval)
            for name, fn in runs.items():
                for n in (1, 2):
                    dt, _ = run_sessions([fn] * n, device,
                                         warmup=fn if warm else None)
                    fps = n * n_p / dt
                    label = (f"{name} x{n}, {'warm' if warm else 'cold'}, "
                             f"switch interval {interval * 1e3:g} ms")
                    out[label] = fps
                    print(f"[sessions] {label}: {fps:.3f} fps aggregate",
                          flush=True)
    finally:
        sys.setswitchinterval(default)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="1088x1920")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_codec_numerics()
    h, w = (int(v) for v in args.size.split("x"))
    g = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    rec = {"device": (torch.cuda.get_device_name(0) if device.type == "cuda"
                      else "cpu"),
           "batches": probe_batches(device, h, w, g),
           "means": probe_means(device, h, w, g),
           "sessions": probe_sessions(device, h, w, g),
           "seconds": time.perf_counter() - t0}
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
