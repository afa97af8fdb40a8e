"""Benchmark of the port: 1080p P-frame encode+decode throughput on one GPU.

    python3 -m vcm_ts_tpu_torch.bench [--dtype f32|bf16|mixed] [--fast-warp]
    python3 -m vcm_ts_tpu_torch.bench --device cpu --size 64x64 --frames 2 \\
        --runs 1

Counterpart of the JAX package's bench.py: the same flags, and ONE JSON
line with the same keys,
  {"metric": ..., "value": N, "unit": "fps", "vs_baseline": N, ...}.
vs_baseline is against the north star of 60 fps (BASELINE.md).

Modes (the protocol of the reference's eval harness: per-frame DMC
encode+decode, 1080p padded to 1088x1920, DPB threaded frame to frame):
- default: the suite, the entropy-estimated fps (median, min and max of
  --runs) plus single-stream pipelined encode and decode, the 2-stream
  batched write-stream aggregate (`write_stream_2x_aggregate_fps`, the
  frames doubled along N) and, in bf16, the f32 estimation fps;
- --estimate-only (also implied by --fast-warp, --fast-shuffle and
  --streams N, as in bench.py): the entropy-estimated fps alone;
- --latency: blocking per-frame latency percentiles;
- --gop N: one IntraNoAR I-frame + (N-1) DMC P-frames through real streams;
- --pipelined-encode / --pipelined-decode: GOP throughput through
  encode_gop / decode_gop (host rANS overlapped with device work); with
  --streams N, N sessions at once through ONE codec, each on its own
  thread and CUDA stream (aggregate fps);
- --write-stream: per-frame compress + decompress through real streams;
  with --streams N, N streams through compress_batch / decompress_batch
  (aggregate fps).

--fast-shuffle is accepted: the port always runs kernels B and C.
--train-step is not ported (training is a later slice) and raises
SystemExit. The TPU probe, chip sentinel and compilation cache of bench.py
have no counterpart here. The completion barrier is
torch.cuda.synchronize().

Weights are the seeded, damped init (utils/weights.py): no DMC or
IntraNoAR checkpoint ships in the repo. `--device` defaults to cuda.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import numpy as np
import torch

from .codec.engine import IntraCodec, VideoCodec, run_sessions
from .models.dmc import make_dpb
from .utils.device import resolve_device, set_codec_numerics
from .utils.precision import cast_params, cast_params_mixed
from .utils.weights import make_dmc, make_intra

NORTH_STAR_FPS = 60.0  # BASELINE.md
IQ, PQ = 0.5, 0.7


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--dtype", choices=["f32", "bf16", "mixed"],
                    default="bf16",
                    help="mixed = bf16 params except the reconstruction "
                         "path, which stays f32 (utils/precision.py)")
    ap.add_argument("--write-stream", action="store_true",
                    help="real-bitstream compress + decompress per frame "
                         "(batched with --streams N)")
    ap.add_argument("--size", default="1088x1920")
    ap.add_argument("--fast-warp", action="store_true",
                    help="two-pass warp, kernel D (ops/warp_twopass.py)")
    ap.add_argument("--fast-shuffle", action="store_true",
                    help="accepted; the port always runs kernels B and C")
    ap.add_argument("--estimate-only", action="store_true",
                    help="single-stream entropy-estimated mode only")
    ap.add_argument("--pipelined-encode", action="store_true",
                    help="encode-only GOP throughput, real bitstream")
    ap.add_argument("--pipelined-decode", action="store_true",
                    help="decode-only GOP throughput, real bitstream")
    ap.add_argument("--streams", type=int, default=1,
                    help="N streams: through the batch axis (estimation, "
                         "--write-stream) or as N concurrent sessions "
                         "(--pipelined-*)")
    ap.add_argument("--latency", action="store_true",
                    help="per-frame latency (ms p50/p95/p99) of the "
                         "entropy-estimated forward, each frame blocking")
    ap.add_argument("--gop", type=int, default=0,
                    help="one I-frame + (N-1) P-frames through real "
                         "container bytes")
    ap.add_argument("--train-step", action="store_true",
                    help="not ported (ROADMAP.md Queue 1 item 10)")
    ap.add_argument("--runs", type=int, default=3,
                    help="timed repetitions per reported number")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _median_of(fn, n: int):
    """(median, min, max) of n timed runs of fn."""
    vals = sorted(fn() for _ in range(max(1, n)))
    return vals[len(vals) // 2], vals[0], vals[-1]


def _cast(model, dtype: str):
    if dtype == "bf16":
        return cast_params(model, torch.bfloat16)
    if dtype == "mixed":
        return cast_params_mixed(model)
    return model


def _refuse(args, ns: int) -> None:
    """SystemExit for what bench.py has and the port does not, and for
    single-stream modes asked for several streams (bench.py asserts)."""
    if args.train_step:
        raise SystemExit("--train-step: training is not ported yet "
                         "(ROADMAP.md Queue 1 item 10)")
    if ns > 1 and (args.latency or args.gop):
        raise SystemExit("--latency and --gop are single-stream")


@torch.no_grad()
def run(args) -> dict:
    """Run the selected mode; returns the JSON line's object."""
    ns = max(1, args.streams)
    _refuse(args, ns)
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_codec_numerics()
    h, w = (int(v) for v in args.size.split("x"))
    size_tag = "1080p" if (h, w) == (1088, 1920) else f"{h}x{w}"
    dtype = torch.float32 if args.dtype == "f32" else torch.bfloat16

    rng = np.random.default_rng(0)
    frames = [torch.from_numpy(rng.random((ns, h, w, 3))).to(device, dtype)
              for _ in range(4)]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ctx = dict(model=_cast(make_dmc(device, args.fast_warp), args.dtype),
               frames=frames, dpb=make_dpb(frames[0]), h=h, w=w, sync=sync,
               args=args, device=device)

    if args.latency:
        stats = bench_latency(ctx)
        return {"metric": f"{size_tag} P-frame enc+dec per-frame latency "
                          f"({args.dtype}, entropy-estimated, blocking)",
                "value": stats["p50_ms"], "unit": "ms",
                "vs_baseline": round(1000.0 / stats["p50_ms"]
                                     / NORTH_STAR_FPS, 4),
                **stats}
    if args.gop:
        enc_fps, dec_fps = bench_gop(ctx)
        e2e = 1.0 / (1.0 / enc_fps + 1.0 / dec_fps)
        return {"metric": f"{size_tag} GOP{args.gop} I+P enc->dec fps/chip "
                          f"({args.dtype}, real bitstream, sequential)",
                "value": round(e2e, 3), "unit": "fps",
                "vs_baseline": round(e2e / NORTH_STAR_FPS, 4),
                "gop_encode_fps": round(enc_fps, 3),
                "gop_decode_fps": round(dec_fps, 3)}
    if args.pipelined_decode or args.pipelined_encode:
        which = "DECODE" if args.pipelined_decode else "ENCODE"
        fn = (bench_pipelined_decode if args.pipelined_decode
              else bench_pipelined_encode)
        if ns == 1:
            return _fps(f"{size_tag} P-frame pipelined {which} fps/chip "
                        f"({args.dtype}, real bitstream)", fn(ctx))
        # ns single-stream sessions at once through one codec
        one = [f[:1] for f in frames]
        fps = fn(dict(ctx, frames=one, dpb=make_dpb(one[0])), ns)
        return _fps(f"{size_tag} P-frame pipelined {which} aggregate "
                    f"fps/chip ({args.dtype}, real bitstream, {ns} "
                    "interleaved streams)", fps)
    if args.write_stream and ns > 1:
        return _fps(f"{size_tag} P-frame enc+dec AGGREGATE fps/chip "
                    f"({args.dtype}, real bitstream, {ns} streams batched)",
                    bench_batched_write(ctx))
    if args.write_stream:
        return _fps(f"{size_tag} P-frame enc+dec fps/chip ({args.dtype}, "
                    "real bitstream)", bench_seq_write(ctx))

    est_fps, est_min, est_max = _median_of(lambda: bench_estimation(ctx),
                                           args.runs)
    result = {
        "metric": f"{size_tag} P-frame enc+dec fps/chip "
                  f"({args.dtype}"
                  f"{', fast-warp' if args.fast_warp else ''}"
                  f"{', fast-shuffle' if args.fast_shuffle else ''}"
                  f"{f', {ns} streams batched' if ns > 1 else ''}"
                  f", entropy-estimated)",
        "value": round(est_fps, 3),
        "unit": "fps",
        "vs_baseline": round(est_fps / NORTH_STAR_FPS, 4),
        "runs": max(1, args.runs),
        "min_fps": round(est_min, 3),
        "max_fps": round(est_max, 3),
    }
    if args.estimate_only or ns > 1 or args.fast_warp or args.fast_shuffle:
        return result

    def _suite(key, fn):
        med, lo, hi = _median_of(fn, args.runs)
        result[key] = round(med, 3)
        result[key + "_min"] = round(lo, 3)
        result[key + "_max"] = round(hi, 3)

    try:
        _suite("pipelined_encode_fps", lambda: bench_pipelined_encode(ctx))
        _suite("pipelined_decode_fps", lambda: bench_pipelined_decode(ctx))
        two = [torch.cat([f, f]) for f in frames]
        ctx2 = dict(ctx, frames=two, dpb=make_dpb(two[0]))
        _suite("write_stream_2x_aggregate_fps",
               lambda: bench_batched_write(ctx2))
        if args.dtype == "bf16":
            ctx32 = dict(ctx, model=make_dmc(device, args.fast_warp),
                         frames=[f.float() for f in frames])
            result["f32_estimation_fps"] = round(bench_estimation(ctx32), 3)
    except Exception as e:  # bench.py: suite extras never kill the headline
        traceback.print_exc()
        result["suite_error"] = f"{type(e).__name__}: {e}"
    return result


def _fps(metric: str, fps: float) -> dict:
    return {"metric": metric, "value": round(fps, 3), "unit": "fps",
            "vs_baseline": round(fps / NORTH_STAR_FPS, 4)}


def bench_estimation(ctx) -> float:
    """Entropy-estimated forward over --frames, DPB threaded; frames/s."""
    args, model, frames = ctx["args"], ctx["model"], ctx["frames"]

    def run_frame(i, dpb, first):
        return model(frames[i % 4], dpb, PQ, PQ, first)["dpb"]

    cur = make_dpb(frames[0])
    for i in range(max(2, args.warmup)):
        cur = run_frame(i, cur, i == 0)
    ctx["sync"]()
    cur = make_dpb(frames[0])
    t0 = time.perf_counter()
    for i in range(args.frames):
        cur = run_frame(i, cur, i == 0)
    ctx["sync"]()
    return frames[0].shape[0] * args.frames / (time.perf_counter() - t0)


def _make_codec(ctx) -> VideoCodec:
    codec = VideoCodec(ctx["model"], device=ctx["device"])
    codec.update()
    return codec


def bench_pipelined_encode(ctx, n_sessions: int = 1) -> float:
    """encode_gop over --frames, in n_sessions sessions at once through one
    codec (run_sessions: a thread and a CUDA stream each, warmed up in that
    thread; the engine keeps no mutable state across a call). Aggregate
    frames/s."""
    args, frames, dpb = ctx["args"], ctx["frames"], ctx["dpb"]
    codec = _make_codec(ctx)
    seq = [frames[i % 4] for i in range(args.frames)]
    dt, _ = run_sessions(
        [lambda: codec.encode_gop(seq, dpb, PQ, PQ)] * n_sessions,
        ctx["device"], warmup=lambda: codec.encode_gop(seq[:2], dpb, PQ, PQ))
    return n_sessions * args.frames / dt


def bench_pipelined_decode(ctx, n_sessions: int = 1) -> float:
    """decode_gop over --frames, in n_sessions sessions at once through one
    codec: one session's host rANS and index waits may overlap the others'
    device stages. Aggregate frames/s."""
    args, frames, dpb = ctx["args"], ctx["frames"], ctx["dpb"]
    h, w = ctx["h"], ctx["w"]
    codec = _make_codec(ctx)
    seq = [frames[i % 4] for i in range(args.frames)]
    streams, _ = codec.encode_gop(seq, dpb, PQ, PQ)
    dt, _ = run_sessions(
        [lambda: codec.decode_gop(dpb, streams, h, w, PQ, PQ)] * n_sessions,
        ctx["device"],
        warmup=lambda: codec.decode_gop(dpb, streams[:2], h, w, PQ, PQ))
    return n_sessions * args.frames / dt


def _write_fps(ctx, run_frame) -> float:
    """--warmup frames off the first DPB, then --frames chained; frames/s
    over every stream of the batch."""
    args, frames = ctx["args"], ctx["frames"]
    dpb = ctx["dpb"]
    for i in range(max(2, args.warmup)):
        run_frame(i, dpb, i == 0)
    ctx["sync"]()
    t0 = time.perf_counter()
    cur = dpb
    for i in range(args.frames):
        cur = run_frame(i, cur, i == 0)
    ctx["sync"]()
    return frames[0].shape[0] * args.frames / (time.perf_counter() - t0)


def bench_batched_write(ctx) -> float:
    """N streams per frame through compress_batch + decompress_batch."""
    frames, h, w = ctx["frames"], ctx["h"], ctx["w"]
    codec = _make_codec(ctx)

    def run_frame(i, dpb, first):
        out = codec.compress_batch(frames[i % 4], dpb, PQ, PQ, first)
        return codec.decompress_batch(dpb, out["bit_streams"], h, w, PQ, PQ,
                                      first)["dpb"]

    return _write_fps(ctx, run_frame)


def bench_seq_write(ctx) -> float:
    """One stream per frame through compress + decompress."""
    frames, h, w = ctx["frames"], ctx["h"], ctx["w"]
    codec = _make_codec(ctx)

    def run_frame(i, dpb, first):
        out = codec.compress(frames[i % 4], dpb, PQ, PQ, first)
        return codec.decompress(dpb, out["bit_stream"], h, w, PQ, PQ,
                                first)["dpb"]

    return _write_fps(ctx, run_frame)


def bench_latency(ctx) -> dict:
    """Blocking per-frame latency of the estimation forward: every frame
    synchronizes before the next is dispatched."""
    args, model, frames = ctx["args"], ctx["model"], ctx["frames"]
    cur = make_dpb(frames[0])
    for i in range(max(2, args.warmup)):
        cur = model(frames[i % 4], cur, PQ, PQ, i == 0)["dpb"]
    ctx["sync"]()

    lat = []
    cur = make_dpb(frames[0])
    for i in range(args.frames):
        t0 = time.perf_counter()
        cur = model(frames[i % 4], cur, PQ, PQ, i == 0)["dpb"]
        ctx["sync"]()
        lat.append((time.perf_counter() - t0) * 1000.0)
    lat = np.sort(np.asarray(lat[1:]))  # drop the first-P-frame variant
    if lat.size == 0:
        raise SystemExit("--latency needs --frames >= 2")

    def q(p):
        return float(np.percentile(lat, p))

    return {"p50_ms": round(q(50), 2), "p95_ms": round(q(95), 2),
            "p99_ms": round(q(99), 2), "mean_ms": round(float(lat.mean()), 2),
            "max_ms": round(float(lat.max()), 2), "n": int(lat.size)}


def bench_gop(ctx):
    """One GOP through real container bytes: IntraCodec encodes frame 0 and
    decodes its own I-stream (the DPB seeds from the decoder's recon), then
    VideoCodec carries the P-frames. Returns (encode_fps, decode_fps)."""
    args, frames = ctx["args"], ctx["frames"]
    h, w, device = ctx["h"], ctx["w"], ctx["device"]
    gop = args.gop
    dtype = frames[0].dtype

    i_codec = IntraCodec(_cast(make_intra(device), args.dtype), device=device)
    i_codec.update()
    codec = _make_codec(ctx)
    seq = [frames[i % 4] for i in range(1, gop)]  # P-frames

    def encode():
        i_stream = i_codec.compress(frames[0], IQ)
        r0 = i_codec.decompress(i_stream, h, w, IQ).to(dtype)
        streams, _ = codec.encode_gop(seq, make_dpb(r0), PQ, PQ)
        return i_stream, streams

    def decode(i_stream, streams):
        r0 = i_codec.decompress(i_stream, h, w, IQ).to(dtype)
        recons, _ = codec.decode_gop(make_dpb(r0), streams, h, w, PQ, PQ)
        ctx["sync"]()
        return recons

    i_s, p_s = encode()  # warm the I-frame and both P-frame variants
    decode(i_s, p_s[:2])

    t0 = time.perf_counter()
    i_s, p_s = encode()
    t1 = time.perf_counter()
    decode(i_s, p_s)
    t2 = time.perf_counter()
    return gop / (t1 - t0), gop / (t2 - t1)


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
