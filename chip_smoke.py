"""Smoke run of the PyTorch/CUDA port on one GPU: kernels, bench, GOPs, serving.

    python3 chip_smoke.py [--out DIR]

Phases (any failed check raises; the script exits non-zero and prints no
result line):
1. setup: the card's name and power limit (nvidia-smi), a parallel nvcc
   build of every kernel in vcm_ts_tpu_torch/csrc for sm_90a, f32 numerics
   with TF32 off and deterministic cuDNN;
2. kernels against their plain PyTorch versions on the card, at the shapes
   the main path gives them (kernels A and B at every main-path shape, in
   f32 and bf16; kernel A under an iid and a smooth flow; kernel B also
   checked to give the same bits for a band of rows alone), with kernel /
   plain / library device times (CUDA events over launches replayed from a
   CUDA graph) beside the back-to-back eager times, the least time the
   card could take (bound) and the launches per frame;
3. a small-input reference: the seeded models on the CPU (plain versions)
   and on the card (kernels) agree;
4. the port bench (vcm_ts_tpu_torch.bench) at 1088x1920: the
   entropy-estimated forward in bf16 with --fast-warp (kernel D launched,
   kernel A not), then bf16, f32 and mixed with the exact warp;
5. the main paths: a seeded, damped init of IntraNoAR (N=192) and DMC
   (64/64/96), one I-frame + 3 P-frames of seeded moving 1088x1920 frames
   encoded into .bin files and decoded, in f32 with the exact warp and in
   bf16 with fast_warp; every decoded frame must equal the encoder's DPB
   recon bit for bit, and every kernel of the path must have launched;
6. serving: kernels A-D launched at N = 2 give each row the bits of its
   N = 1 launch; two sequences at two rate points, I + 2 P at N = 2,
   through compress_batch / decompress_batch in f32 (exact warp) and in
   bf16 with fast_warp, streams byte-equal to each row coded alone and
   the batch decode equal to the encoder's DPB and to each row decoded
   alone (launch counts reset before the batched run, peak memory);
   two threads on their own CUDA streams through one codec, equal to one
   thread; the port bench's --write-stream (1 and 2 streams) and
   --pipelined-encode / --pipelined-decode (1 and 2 sessions) in bf16;
   encode_gop / decode_gop of 4 bf16 fast_warp P-frames beside a loop of
   compress / decompress calls (wall, device-busy, idle share). Every
   line names the card and its power limit.

The last three lines of standard output are the `kernels` JSON object, the
nvidia-smi line, and then {"ok": true, "device": {...}}. A longer record
(chip_smoke.json) and the GOPs' .bin files go to --out (default
smoke_out/ in the repo). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s
PEAK = {torch.float32: 67e12, torch.bfloat16: 989e12}  # flop/s, dense
REPLACES = {
    "warp": "vcm_ts_tpu/ops/warp.py:49 (_warp_one_gather; XLA gather)",
    "warp_twopass": "vcm_ts_tpu/ops/warp_pallas.py:35 (_warp_kernel, via "
                    "flow_warp_pallas:88)",
    "subpel_conv1x1": "vcm_ts_tpu/ops/subpel_pallas.py:169 (_conv1x1_kernel)",
    "pixel_shuffle_relayout": "vcm_ts_tpu/ops/subpel_pallas.py:59 "
                              "(_relayout_kernel) + :73 "
                              "(_relayout_full_kernel)",
}
SOURCES = {"warp": "vcm_ts_tpu_torch/csrc/warp.cu",
           "subpel_conv1x1": "vcm_ts_tpu_torch/csrc/subpel_conv1x1.cu",
           "pixel_shuffle_relayout": "vcm_ts_tpu_torch/csrc/pixel_shuffle.cu",
           "warp_twopass": "vcm_ts_tpu_torch/csrc/warp_twopass.cu"}
# the __global__ functions of csrc/*.cu, as the profiler names them
PORT_KERNEL_FUNCS = ("warp_kernel", "warp_narrow_kernel", "warp_twopass_kernel",
                     "conv_mma_bf16", "conv_fma_f32", "conv_narrow",
                     "relayout_kernel")
H, W = 1088, 1920
IQ, PQ = 0.5, 0.7
CL = torch.channels_last


def say(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=10):
    """Mean device time of fn() over `iters` calls replayed from one CUDA
    graph: no host work between the launches, so unlike cuda_ms it does
    not include the Python dispatch of a call when that outlasts the
    device's work (small tensors)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def times(kernel, plain, library):
    """Device (graph) and back-to-back (eager) times of a kernel, its plain
    version and its library yardstick (None: no such call)."""
    t = dict(ms=graph_ms(kernel), eager_ms=cuda_ms(kernel),
             plain_ms=graph_ms(plain, iters=3), library_ms=None,
             library_eager_ms=None)
    if library is not None:
        t.update(library_ms=graph_ms(library),
                 library_eager_ms=cuda_ms(library))
    return t


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# ------------------------------------------------------------------ phase 2
def _grid(flow):
    """F.grid_sample's grid for a pixel flow (align_corners=True)."""
    _, _, h, w = flow.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=flow.device),
                            torch.arange(w, device=flow.device),
                            indexing="ij")
    return torch.stack([(xs + flow[0, 0]) * (2.0 / (w - 1)) - 1,
                        (ys + flow[0, 1]) * (2.0 / (h - 1)) - 1], -1)[None]


# Kernel A's main-path calls at 1088x1920: (label, channels of each tensor,
# H, W, launches per P-frame encoded / P-frame decoded / I-frame decoded).
WARP_SHAPES = (
    ("67ch packed (3+64)", (3, 64), H, W, (1, 1, 0)),
    ("3ch SpyNet level 0", (3,), H, W, (1, 0, 0)),
    ("3ch SpyNet level 1", (3,), H // 2, W // 2, (1, 0, 0)),
    ("3ch SpyNet level 2", (3,), H // 4, W // 4, (1, 0, 0)),
    ("3ch SpyNet level 3", (3,), H // 8, W // 8, (1, 0, 0)),
    ("64ch context2", (64,), H // 2, W // 2, (1, 1, 0)),
    ("64ch context3", (64,), H // 4, W // 4, (1, 1, 0)),
)


def make_flow(kind, h, w, g):
    """iid: N(0, 8^2) per pixel, a worst case for tap locality; smooth: the
    same field at 1/16 resolution, upsampled bilinearly, as motion is."""
    if kind == "iid":
        flow = torch.randn((1, 2, h, w), device="cuda", generator=g) * 8
    else:
        coarse = torch.randn((1, 2, h // 16, w // 16), device="cuda",
                             generator=g) * 8
        flow = F.interpolate(coarse, size=(h, w), mode="bilinear",
                             align_corners=False)
    return flow.contiguous(memory_format=CL)


def check_warp(g):
    """Kernel A at every main-path shape, f32 and bf16 (data and flow in
    the working dtype, as in the model), under an iid and a smooth flow."""
    from vcm_ts_tpu_torch.ops import warp as tw

    rows = []
    for name, chans, h, w, per_frame in WARP_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for kind in ("iid", "smooth"):
                ims = [(torch.rand if c == 3 else torch.randn)(
                    (1, c, h, w), device="cuda", generator=g).to(
                        dtype=dtype, memory_format=CL) for c in chans]
                flow = make_flow(kind, h, w, g).to(dtype)
                got = tw.warp_cuda(ims, flow)
                want = tw.warp_plain(ims, flow)
                err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(got, want))
                tol = 0.0  # the kernel rounds every op as plain does
                dt = str(dtype)[6:]
                size = "" if (h, w) == (H, W) else f" {h}x{w}"
                label = (f"{name}{size} {'f32' if dt == 'float32' else dt}"
                         + ("" if kind == "iid" else ", smooth flow"))
                if not err <= tol:
                    raise AssertionError(f"warp {label}: max_abs_err {err} "
                                         f"> {tol}")
                cat = torch.cat(ims, 1) if len(ims) > 1 else ims[0]
                grid = _grid(flow.float()).to(dtype)
                t = times(lambda: tw.warp_cuda(ims, flow),
                          lambda: tw.warp_plain(ims, flow),
                          lambda: F.grid_sample(
                              cat, grid, mode="bilinear",
                              padding_mode="border", align_corners=True))
                b, by = bound_ms(2 * nbytes(*ims) + nbytes(flow),
                                 11 * cat.numel(), torch.float32)
                rows.append(dict(
                    name="warp", shape=label, dtype=dt, flow=kind,
                    max_abs_err=err, tol=tol, **t,
                    library="F.grid_sample(border, align_corners=True)",
                    bound_ms=b, bound_by=by, per_frame=per_frame))
    return rows


def check_warp_twopass(g):
    """Kernel D at the fast_warp path's shapes, flows past the bound D.
    Beside it, kernel A and F.grid_sample on the same tensor and flow: they
    compute the exact warp that fast_warp stands in for."""
    from vcm_ts_tpu_torch.ops import warp as tw
    from vcm_ts_tpu_torch.ops import warp_twopass as td

    rows = []
    for c, h, w, d, dtype in ((64, H, W, 24, torch.float32),
                              (64, H, W, 24, torch.bfloat16),
                              (3, H, W, 16, torch.float32),
                              (64, H // 2, W // 2, 12, torch.float32),
                              (64, H // 4, W // 4, 6, torch.float32)):
        im = torch.rand((1, c, h, w), device="cuda", generator=g).to(
            dtype=dtype, memory_format=CL)
        flow = (torch.randn((1, 2, h, w), device="cuda", generator=g)
                * (1.5 * d)).to(memory_format=CL)
        beyond = float((flow.abs() > d).float().mean())
        got = td.warp_twopass_cuda(im, flow, d)
        want = td.warp_twopass_plain(im, flow, d)
        err = float((got.float() - want.float()).abs().max())
        tol = 0.0  # the kernel rounds every op as the plain version does
        label = f"{c}ch {h}x{w} D={d} {str(dtype)[6:]}"
        if not err <= tol:
            raise AssertionError(f"warp_twopass {label}: max_abs_err {err} "
                                 f"> {tol}")
        t = times(lambda: td.warp_twopass_cuda(im, flow, d),
                  lambda: td.warp_twopass_plain(im, flow, d), None)
        exact = graph_ms(lambda: tw.warp_cuda([im], flow))
        grid = _grid(flow).to(dtype)
        lib = graph_ms(lambda: F.grid_sample(
            im, grid, mode="bilinear", padding_mode="border",
            align_corners=True))
        b, by = bound_ms(2 * nbytes(im) + nbytes(flow), 9 * im.numel(),
                         torch.float32)
        rows.append(dict(name="warp_twopass", shape=label,
                         dtype=str(dtype)[6:], max_abs_err=err, tol=tol,
                         **t, library=None,
                         exact_warp_ms=exact, grid_sample_ms=lib,
                         flow_beyond_d=beyond, bound_ms=b, bound_by=by))
    return rows


# Kernel B's main-path calls at 1088x1920: (Cin, C, input H, W, launches
# per P-frame encoded / P-frame decoded / I-frame decoded); models/dmc.py,
# models/intra.py, models/video_net.py, ops/layers.py.
CONV1X1_SHAPES = (
    (64, 32, H // 2, W // 2, (2, 2, 1)),     # UNet up2
    (192, 16, H // 2, W // 2, (0, 0, 1)),    # intra decoder, last layer
    (128, 64, H // 4, W // 4, (2, 2, 1)),    # UNet up3
    (64, 64, H // 16, W // 16, (2, 2, 0)),   # mv decoder upsample blocks
    (64, 64, H // 8, W // 8, (2, 2, 0)),
    (64, 64, H // 4, W // 4, (2, 2, 0)),
    (64, 2, H // 2, W // 2, (1, 1, 0)),      # mv decoder, last layer
    (64, 64, H // 64, W // 64, (1, 1, 0)),   # mv hyper decoder
    (96, 96, H // 32, W // 32, (1, 1, 0)),
    (96, 96, H // 64, W // 64, (1, 1, 0)),   # contextual hyper decoder
    (144, 144, H // 32, W // 32, (1, 1, 0)),
    (192, 192, H // 16, W // 16, (0, 0, 2)),  # intra decoder upsample blocks
    (192, 192, H // 8, W // 8, (0, 0, 2)),
    (192, 192, H // 4, W // 4, (0, 0, 2)),
    (192, 192, H // 64, W // 64, (0, 0, 1)),  # intra hyper decoder
    (288, 288, H // 32, W // 32, (0, 0, 1)),
)


def check_subpel_conv1x1(g):
    """Kernel B at every main-path shape in f32 and bf16, against its plain
    version; beside it one cuDNN 1x1 F.conv2d (channels_last, bias, no
    shuffle) on the same x, timed only. A band of rows of x must give the
    same bits as those rows inside the whole tensor."""
    from vcm_ts_tpu_torch.ops import subpel as ts

    rows = []
    for cin, c, h, w, per_frame in CONV1X1_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((1, cin, h, w), device="cuda", generator=g).to(
                dtype=dtype, memory_format=CL)
            wk = (torch.randn((4, cin, c), device="cuda", generator=g)
                  / cin ** 0.5).to(dtype)
            bk = (torch.randn((4, c), device="cuda", generator=g) * 0.1).to(
                dtype)
            got = ts.subpel_conv1x1_cuda(x, wk, bk, 2)
            want = ts.subpel_conv1x1_plain(x, wk, bk, 2)
            err = float((got.float() - want.float()).abs().max())
            scale = max(1.0, float(want.float().abs().max()))
            # f32: both sum in f32 in other orders; bf16: both round an
            # f32 sum to bf16, so they may land one or two ulps apart
            tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6 * scale
            label = f"{cin}->{c} at {h}x{w} {str(dtype)[6:]}"
            if not err <= tol:
                raise AssertionError(f"subpel_conv1x1 {label}: max_abs_err "
                                     f"{err} > {tol}")
            h0, h1 = h // 4, h // 4 + h // 2 + 1
            band = x[:, :, h0:h1].contiguous(memory_format=CL)
            if not torch.equal(ts.subpel_conv1x1_cuda(band, wk, bk, 2),
                               got[:, :, 2 * h0:2 * h1]):
                raise AssertionError(f"subpel_conv1x1 {label}: rows {h0}:"
                                     f"{h1} alone give other bits than in "
                                     "the whole tensor")
            w4 = wk.permute(0, 2, 1).reshape(4 * c, cin, 1, 1).contiguous(
                memory_format=CL)
            b4 = bk.reshape(4 * c)
            t = times(lambda: ts.subpel_conv1x1_cuda(x, wk, bk, 2),
                      lambda: ts.subpel_conv1x1_plain(x, wk, bk, 2),
                      lambda: F.conv2d(x, w4, b4))
            b, by = bound_ms(nbytes(x, wk, bk, got), 2 * h * w * cin * 4 * c,
                             dtype)
            rows.append(dict(name="subpel_conv1x1", shape=label,
                             dtype=str(dtype)[6:], max_abs_err=err, tol=tol,
                             m_independent=True, **t, library="F.conv2d 1x1 "
                             "(channels_last, bias, no shuffle; cuDNN)",
                             bound_ms=b, bound_by=by, per_frame=per_frame))
    return rows


def check_relayout(g):
    from vcm_ts_tpu_torch.ops import subpel as ts

    rows = []
    h, w = H // 2, W // 2
    for c in (64, 32):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((1, 4 * c, h, w), device="cuda", generator=g).to(
                dtype=dtype, memory_format=CL)
            got = ts.relayout_cuda(x, 2)
            want = ts.relayout_plain(x, 2)
            if not torch.equal(got, want):
                raise AssertionError(f"relayout C={c} {dtype}: not "
                                     "bit-identical to the plain version")
            # the same output from torch's pixel_shuffle of the c-major input
            xc = x.reshape(1, 4, c, h, w).transpose(1, 2).reshape(
                1, 4 * c, h, w).contiguous(memory_format=CL)
            if not torch.equal(F.pixel_shuffle(xc, 2), got):
                raise AssertionError("k-major relayout != pixel_shuffle")
            t = times(lambda: ts.relayout_cuda(x, 2),
                      lambda: ts.relayout_plain(x, 2),
                      lambda: F.pixel_shuffle(xc, 2))
            b, by = bound_ms(2 * nbytes(x), 0, dtype)
            label = f"C={c} {h}x{w}->{H}x{W} {str(dtype)[6:]}"
            rows.append(dict(name="pixel_shuffle_relayout", shape=label,
                             dtype=str(dtype)[6:], max_abs_err=0.0, tol=0.0,
                             **t, library="F.pixel_shuffle (c-major input)",
                             bound_ms=b, bound_by=by))
    return rows


# --------------------------------------------------------- phases 3, 4, 5
def moving_frames(n, h, w, seed=0):
    """Seeded smooth frames that move 4 pixels right per frame (NHWC)."""
    g = torch.Generator().manual_seed(seed)
    base = torch.rand((1, 3, h // 16, w // 16), generator=g)
    base = F.interpolate(base, size=(h, w), mode="bilinear",
                         align_corners=False)
    return [torch.roll(base, 4 * t, dims=3).permute(0, 2, 3, 1).contiguous()
            for t in range(n)]


def small_reference(intra, dmc):
    """The seeded models on the CPU (plain versions) and on the card
    (kernels) agree on a 64x64 input."""
    from vcm_ts_tpu_torch.models.dmc import make_dpb

    frames = moving_frames(2, 64, 64, seed=3)
    outs = {}
    for dev in ("cpu", "cuda"):
        i = intra.to(dev)
        d = dmc.to(dev)
        with torch.no_grad():
            x0, x1 = (f.to(dev) for f in frames)
            oi = i(x0, IQ)
            od = d(x1, make_dpb(oi["x_hat"]), PQ, PQ, is_first_p=True)
        outs[dev] = (oi["x_hat"].cpu(), od["dpb"]["ref_frame"].cpu(),
                     float(od["bpp"]))
    intra.to("cuda")
    dmc.to("cuda")
    err_i = float((outs["cpu"][0] - outs["cuda"][0]).abs().max())
    err_p = float((outs["cpu"][1] - outs["cuda"][1]).abs().max())
    # f32 conv stacks in cuDNN vs the CPU backend: another summation order
    tol = 1e-3
    if not (err_i <= tol and err_p <= tol):
        raise AssertionError(f"GPU vs CPU at 64x64: I {err_i}, P {err_p} "
                             f"> {tol}")
    return {"intra_max_abs_err": err_i, "p_recon_max_abs_err": err_p,
            "tol": tol, "bpp_cpu": outs["cpu"][2], "bpp_cuda": outs["cuda"][2]}


def run_bench(label, argv):
    """One run of the port bench at 1088x1920, launches counted over it."""
    from vcm_ts_tpu_torch import bench
    from vcm_ts_tpu_torch.ops import cuda_build

    cuda_build.reset_launches()
    t = time.perf_counter()
    res = bench.run(bench.parse_args(argv))
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    fast = "--fast-warp" in argv
    if fast and not (launches["warp_twopass"] > 0 and launches["warp"] == 0):
        raise AssertionError(f"bench {label}: fast_warp must launch kernel D "
                             f"and not kernel A, launches {launches}")
    if not fast and not (launches["warp"] > 0
                         and launches["warp_twopass"] == 0):
        raise AssertionError(f"bench {label}: the exact warp must launch "
                             f"kernel A and not kernel D, launches {launches}")
    if not res["value"] > 0:
        raise AssertionError(f"bench {label}: no throughput: {res}")
    return dict(res, label=label, argv=argv, launches=launches,
                held_s=time.perf_counter() - t)


def run_gop(intra, dmc, out_dir, tag, expect):
    """I + 3 P through .bin files; `expect` names the kernels the path must
    launch (every other kernel must not launch)."""
    from vcm_ts_tpu_torch.codec import bitstream as bs
    from vcm_ts_tpu_torch.codec.engine import IntraCodec, VideoCodec
    from vcm_ts_tpu_torch.models.dmc import make_dpb
    from vcm_ts_tpu_torch.ops import cuda_build

    ic = IntraCodec(intra, device="cuda")
    vc = VideoCodec(dmc, device="cuda")
    ic.update()
    vc.update()
    frames = [f.cuda() for f in moving_frames(4, H, W, seed=1)]
    gop = len(frames)

    def encode():
        i_stream = ic.compress(frames[0], IQ)
        r0 = ic.decompress(i_stream, H, W, IQ)
        dpb = make_dpb(r0)
        p_streams, recons = [], [r0]
        for t, x in enumerate(frames[1:]):
            out = vc.compress(x, dpb, PQ, PQ, is_first_p=t == 0)
            dpb = out["dpb"]
            p_streams.append(out["bit_stream"])
            recons.append(dpb["ref_frame"])
        torch.cuda.synchronize()
        return i_stream, p_streams, recons, dpb

    def write_bin(i_stream, p_streams):
        paths = [os.path.join(out_dir, f"gop_{tag}_i.bin")]
        bs.encode_i(H, W, int(round(IQ * 100)), i_stream, paths[0])
        for t, s in enumerate(p_streams):
            paths.append(os.path.join(out_dir, f"gop_{tag}_p{t}.bin"))
            q = int(round(PQ * 100))
            bs.encode_p(s, q, q, paths[-1])
        return paths

    def decode(paths):
        h, w, qi, i_stream = bs.decode_i(paths[0])
        r0 = ic.decompress(i_stream, h, w, qi / 100)
        p = [bs.decode_p(pp) for pp in paths[1:]]
        recons, _ = vc.decode_gop(make_dpb(r0), [s for _, _, s in p], h, w,
                                  p[0][0] / 100, p[0][1] / 100)
        torch.cuda.synchronize()
        return [r0] + recons

    # warm-up GOP through encode_gop/decode_gop (cuDNN plans, tables)
    i_w = ic.compress(frames[0], IQ)
    r0_w = ic.decompress(i_w, H, W, IQ)
    streams_w, _ = vc.encode_gop(frames[1:], make_dpb(r0_w), PQ, PQ)
    vc.decode_gop(make_dpb(r0_w), streams_w, H, W, PQ, PQ)
    torch.cuda.synchronize()

    cuda_build.reset_launches()
    t0 = time.perf_counter()
    i_stream, p_streams, enc_recons, enc_dpb = encode()
    t1 = time.perf_counter()
    paths = write_bin(i_stream, p_streams)
    t2 = time.perf_counter()
    dec_recons = decode(paths)
    t3 = time.perf_counter()
    launches = dict(cuda_build.LAUNCHES)

    if i_stream != i_w or p_streams != streams_w:
        raise AssertionError("encode_gop and per-frame compress wrote "
                             "different streams")
    psnr = []
    for t, (e, d, x) in enumerate(zip(enc_recons, dec_recons, frames)):
        if d.shape != (1, H, W, 3) or not torch.isfinite(d).all():
            raise AssertionError(f"frame {t}: bad decoded frame")
        if not torch.equal(e, d):
            raise AssertionError(f"frame {t}: decoded frame differs from the "
                                 "encoder's DPB recon")
        psnr.append(float(-10 * torch.log10(((d - x) ** 2).mean())))
    wrong = {k: v for k, v in launches.items() if (v > 0) != (k in expect)}
    if wrong:
        raise AssertionError(f"GOP {tag}: must launch exactly {expect}, "
                             f"launches {launches}")
    sizes = [os.path.getsize(p) for p in paths]
    profile = profile_p_frame(vc, frames[1], enc_dpb)
    return {"tag": tag, "frames": gop, "height": H, "width": W, "iq": IQ,
            "pq": PQ,
            "encode_s": t1 - t0, "decode_s": t3 - t2,
            "encode_fps": gop / (t1 - t0), "decode_fps": gop / (t3 - t2),
            "bin_bytes": sizes, "psnr_db": psnr, "launches": launches,
            "profile": profile}


def profile_ms(fn):
    """fn() under torch.profiler: wall ms, device-busy ms (the sum of
    kernel times), the idle share, the kernels that take the most device
    time and the port's kernels' sums."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.device_time / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    ours = {}
    for k, (ms, n) in by_name.items():
        f = next((f for f in PORT_KERNEL_FUNCS if f + "<" in k
                  or f + "(" in k), None)
        if f:
            t, c = ours.get(f, (0.0, 0))
            ours[f] = (t + ms, c + n)
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall,
            "top_kernels": [{"name": k[:90], "ms": v[0], "launches": v[1]}
                            for k, v in top],
            "port_kernels": {k: {"ms": v[0], "launches": v[1]}
                             for k, v in sorted(ours.items())}}


def profile_p_frame(vc, x, dpb):
    """Where one chained P-frame's time goes (frame `x` coded against the
    encoder's DPB `dpb`, then its stream decoded against the same DPB),
    for compress and decompress (profile_ms)."""
    stream = []
    return {"compress": profile_ms(lambda: stream.append(
                vc.compress(x, dpb, PQ, PQ)["bit_stream"])),
            "decompress": profile_ms(lambda: vc.decompress(
                dpb, stream[0], H, W, PQ, PQ))}


# ------------------------------------------------------------------ phase 6
SERVE_IQ = (IQ, 0.3)  # the rate point of each stream of an N = 2 batch
SERVE_PQ = (PQ, 0.45)


def _row(t, i):
    return t[i:i + 1]


def check_kernels_batched(g):
    """Kernels A-D at their headline shapes, f32 and bf16, launched at
    N = 2: each row equals the N = 1 launch on that row bit for bit."""
    from vcm_ts_tpu_torch.ops import subpel as ts
    from vcm_ts_tpu_torch.ops import warp as tw
    from vcm_ts_tpu_torch.ops import warp_twopass as td

    def rnd(*shape, dtype):
        return torch.randn(shape, device="cuda", generator=g).to(
            dtype=dtype, memory_format=CL)

    checked = []
    for dtype in (torch.float32, torch.bfloat16):
        flow = torch.cat([make_flow("iid", H, W, g) for _ in range(2)])
        ims = [rnd(2, 3, H, W, dtype=dtype), rnd(2, 64, H, W, dtype=dtype)]
        x_b = rnd(2, 64, H // 2, W // 2, dtype=dtype)
        w_b = (torch.randn((4, 64, 32), device="cuda", generator=g)
               / 8).to(dtype)
        b_b = (torch.randn((4, 32), device="cuda", generator=g) * 0.1).to(
            dtype)
        x_c = rnd(2, 256, H // 2, W // 2, dtype=dtype)
        im_d = rnd(2, 64, H, W, dtype=dtype)
        flow_d = (flow * 4.5).contiguous(memory_format=CL)
        cases = (
            ("warp 67ch packed", lambda r: tw.warp_cuda(
                [r(t) for t in ims], r(flow))),
            ("subpel_conv1x1 64->32", lambda r: [ts.subpel_conv1x1_cuda(
                r(x_b), w_b, b_b, 2)]),
            ("pixel_shuffle_relayout C=64", lambda r: [ts.relayout_cuda(
                r(x_c), 2)]),
            ("warp_twopass 64ch D=24", lambda r: [td.warp_twopass_cuda(
                r(im_d), r(flow_d), 24)]),
        )
        for name, fn in cases:
            batched = fn(lambda t: t)
            for i in range(2):
                alone = fn(lambda t, i=i: _row(t, i))
                if not all(torch.equal(_row(a, i), b)
                           for a, b in zip(batched, alone)):
                    raise AssertionError(f"{name} {dtype}: row {i} at N = 2 "
                                         "differs from its N = 1 launch")
            checked.append(f"{name} {str(dtype)[6:]}")
    return checked


def _qrows(qs):
    return torch.tensor(qs, dtype=torch.float32).reshape(-1, 1, 1, 1)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _dpb_equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def run_serving_batch(ic, vc, tag, expect):
    """Two sequences at two rate points, I + 2 P at N = 2 through
    compress_batch / decompress_batch, against each row coded and decoded
    alone: streams byte-equal, the batch decode equal to the encoder's DPB
    and to the rows decoded alone, bit for bit, with the launch counts
    reset before the batched pass. (Its convs run row by row, on the
    cuDNN plans the GOPs before it made: no warm-up pass.)"""
    from vcm_ts_tpu_torch.models.dmc import make_dpb
    from vcm_ts_tpu_torch.ops import cuda_build

    seqs = [moving_frames(3, H, W, seed=s) for s in (1, 2)]
    xs = [torch.cat([sq[t] for sq in seqs]).cuda() for t in range(3)]
    iq, pq = _qrows(SERVE_IQ), _qrows(SERVE_PQ)

    def batched():
        ms = {}
        i_s, ms["i_compress"] = _timed(lambda: ic.compress_batch(xs[0], iq))
        r0, ms["i_decompress"] = _timed(
            lambda: ic.decompress_batch(i_s, H, W, iq))
        enc, dec, p_s = make_dpb(r0), make_dpb(r0), []
        for t in (1, 2):
            out, ms[f"p{t}_compress"] = _timed(lambda: vc.compress_batch(
                xs[t], enc, pq, pq, t == 1))
            d, ms[f"p{t}_decompress"] = _timed(lambda: vc.decompress_batch(
                dec, out["bit_streams"], H, W, pq, pq, t == 1))
            enc, dec = out["dpb"], d["dpb"]
            if not _dpb_equal(enc, dec):
                raise AssertionError(f"serving {tag}: P-frame {t} batch "
                                     "decode != encoder DPB")
            p_s.append(out["bit_streams"])
        return i_s, r0, p_s, enc, ms

    cuda_build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    i_s, r0, p_s, enc, ms_b = batched()
    launches = dict(cuda_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    wrong = {k: v for k, v in launches.items() if (v > 0) != (k in expect)}
    if wrong:
        raise AssertionError(f"serving {tag}: must launch exactly {expect}, "
                             f"launches {launches}")

    ms_1 = {}
    for i in range(2):
        q_i, q_p = _row(iq, i), _row(pq, i)
        s, ms = _timed(lambda: ic.compress(_row(xs[0], i), q_i))
        ms_1["i_compress"] = ms_1.get("i_compress", 0.0) + ms
        if s != i_s[i]:
            raise AssertionError(f"serving {tag}: I stream {i} batched != "
                                 "alone")
        r, ms = _timed(lambda: ic.decompress(s, H, W, q_i))
        ms_1["i_decompress"] = ms_1.get("i_decompress", 0.0) + ms
        if not torch.equal(r, _row(r0, i)):
            raise AssertionError(f"serving {tag}: I row {i} batch decode "
                                 "!= alone")
        e_dpb, d_dpb = make_dpb(r), make_dpb(r)
        for t in (1, 2):
            out, ms = _timed(lambda: vc.compress(_row(xs[t], i), e_dpb, q_p,
                                                 q_p, t == 1))
            ms_1[f"p{t}_compress"] = ms_1.get(f"p{t}_compress", 0.0) + ms
            if out["bit_stream"] != p_s[t - 1][i]:
                raise AssertionError(f"serving {tag}: P-frame {t} stream {i}"
                                     " batched != alone")
            d, ms = _timed(lambda: vc.decompress(d_dpb, out["bit_stream"], H,
                                                 W, q_p, q_p, t == 1))
            ms_1[f"p{t}_decompress"] = ms_1.get(f"p{t}_decompress", 0.0) + ms
            e_dpb, d_dpb = out["dpb"], d["dpb"]
        if not (_dpb_equal(e_dpb, d_dpb)
                and _dpb_equal(d_dpb, {k: _row(v, i)
                                       for k, v in enc.items()})):
            raise AssertionError(f"serving {tag}: row {i} decoded alone != "
                                 "the batch")
    return {"tag": tag, "iq": SERVE_IQ, "pq": SERVE_PQ,
            "stream_bytes": [[len(s) for s in i_s]]
            + [[len(s) for s in ps] for ps in p_s],
            "batch_ms": ms_b, "two_alone_ms": ms_1, "launches": launches,
            "peak_bytes": peak}


def run_serving_threads(ic, vc, tag):
    """Two threads, each on its own CUDA stream, run encode_gop and then
    decode_gop of one I + 2 P sequence through one codec: each equals the
    single-thread result (timed after a warm-up in each thread)."""
    from vcm_ts_tpu_torch.codec.engine import run_sessions
    from vcm_ts_tpu_torch.models.dmc import make_dpb

    frames = [f.cuda() for f in moving_frames(3, H, W, seed=4)]
    r0 = ic.decompress(ic.compress(frames[0], IQ), H, W, IQ)
    dpb0 = make_dpb(r0)
    ref, _ = vc.encode_gop(frames[1:], dpb0, PQ, PQ)
    ref_rec, _ = vc.decode_gop(dpb0, ref, H, W, PQ, PQ)
    def enc():
        return vc.encode_gop(frames[1:], dpb0, PQ, PQ)[0]

    def dec():
        return vc.decode_gop(dpb0, ref, H, W, PQ, PQ)[0]

    t_enc, encs = run_sessions([enc] * 2, "cuda", warmup=enc)
    t_dec, decs = run_sessions([dec] * 2, "cuda", warmup=dec)
    for k in range(2):
        if encs[k] != ref:
            raise AssertionError(f"threads {tag}: session {k} wrote other "
                                 "streams than one thread")
        if not all(torch.equal(a, b) for a, b in zip(decs[k], ref_rec)):
            raise AssertionError(f"threads {tag}: session {k} decoded other "
                                 "frames than one thread")
    return {"tag": tag, "sessions": 2, "p_frames": 2,
            "encode_s": t_enc, "decode_s": t_dec}


def profile_gop_overlap(ic, vc, tag, n_p=4):
    """encode_gop / decode_gop of n_p P-frames beside a sequential loop of
    compress / decompress calls (no overlap): wall ms without the profiler
    (min of two, in the order loop, gop, gop, loop), and wall, device-busy
    and idle share under it (profile_ms)."""
    from vcm_ts_tpu_torch.models.dmc import make_dpb

    frames = [f.cuda() for f in moving_frames(n_p + 1, H, W, seed=5)]
    r0 = ic.decompress(ic.compress(frames[0], IQ), H, W, IQ)
    dpb0 = make_dpb(r0)
    p = frames[1:]
    streams, _ = vc.encode_gop(p, dpb0, PQ, PQ)

    def enc_loop():
        dpb = dpb0
        for t, x in enumerate(p):
            dpb = vc.compress(x, dpb, PQ, PQ, t == 0)["dpb"]

    def dec_loop():
        dpb = dpb0
        for t, s in enumerate(streams):
            dpb = vc.decompress(dpb, s, H, W, PQ, PQ, t == 0)["dpb"]

    runs = {"compress loop": enc_loop,
            "encode_gop": lambda: vc.encode_gop(p, dpb0, PQ, PQ),
            "decompress loop": dec_loop,
            "decode_gop": lambda: vc.decode_gop(dpb0, streams, H, W, PQ,
                                                PQ)}
    wall = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):
        for k in order:
            wall[k].append(_timed(runs[k])[1])
    out = {}
    for k, fn in runs.items():
        prof = profile_ms(fn)
        out[k] = {"wall_ms": min(wall[k]), "fps": n_p * 1e3 / min(wall[k]),
                  **{f"profiled_{m}": prof[m] for m in
                     ("wall_ms", "device_busy_ms", "idle_share")},
                  "top_kernels": prof["top_kernels"][:5]}
    return {"tag": tag, "p_frames": n_p, **out}


def run_serving(intra, dmc, intra16, dmc16, smi):
    """Phase 6: batched serving, concurrent sessions, the bench's serving
    modes and the overlapped GOP loops; every line ends with the card."""
    from vcm_ts_tpu_torch.codec.engine import IntraCodec, VideoCodec

    rec = {"batch": [], "threads": [], "bench": [], "overlap": None}
    for tag, (mi, md), expect in (
            ("f32", (intra, dmc), {"warp", "subpel_conv1x1",
                                   "pixel_shuffle_relayout"}),
            ("bf16_fast_warp", (intra16, dmc16),
             {"warp_twopass", "subpel_conv1x1", "pixel_shuffle_relayout"})):
        ic, vc = IntraCodec(mi, device="cuda"), VideoCodec(md, device="cuda")
        ic.update()
        vc.update()
        t = time.perf_counter()
        b = run_serving_batch(ic, vc, tag, expect)
        rec["batch"].append(b)
        say(f"[serving {tag}] N=2 I+2P {W}x{H}, q {SERVE_IQ}/{SERVE_PQ}: "
            "batched streams == each row alone, batch decode == encoder DPB "
            f"== rows decoded alone; stream bytes {b['stream_bytes']}; "
            f"batch ms {b['batch_ms']}; two rows alone ms "
            f"{b['two_alone_ms']}; peak {b['peak_bytes'] / 2**30:.2f} GiB; "
            f"launches {b['launches']} ({time.perf_counter() - t:.1f} s; "
            f"{smi})")
        th = run_serving_threads(ic, vc, tag)
        rec["threads"].append(th)
        say(f"[serving {tag}] 2 threads x (encode_gop, decode_gop) of 2 "
            "P-frames on their own streams == one thread: encode "
            f"{th['encode_s']:.3f} s, decode {th['decode_s']:.3f} s ({smi})")
        if tag == "bf16_fast_warp":
            ov = profile_gop_overlap(ic, vc, tag)
            rec["overlap"] = ov
            for k in ("compress loop", "encode_gop", "decompress loop",
                      "decode_gop"):
                v = ov[k]
                say(f"[serving {tag}] {k} of {ov['p_frames']} P-frames: "
                    f"wall {v['wall_ms']:.1f} ms ({v['fps']:.3f} fps); "
                    f"profiled wall {v['profiled_wall_ms']:.1f} ms, device "
                    f"busy {v['profiled_device_busy_ms']:.1f} ms, idle share "
                    f"{v['profiled_idle_share']:.3f} ({smi})")
    common = ["--size", f"{H}x{W}", "--frames", "4", "--warmup", "1",
              "--runs", "1", "--dtype", "bf16"]
    for label, extra in (("write-stream", ["--write-stream"]),
                         ("write-stream x2", ["--write-stream", "--streams",
                                              "2"]),
                         ("pipelined-encode x1", ["--pipelined-encode"]),
                         ("pipelined-encode x2", ["--pipelined-encode",
                                                  "--streams", "2"]),
                         ("pipelined-decode x1", ["--pipelined-decode"]),
                         ("pipelined-decode x2", ["--pipelined-decode",
                                                  "--streams", "2"])):
        b = run_bench(f"bf16 {label}", common + extra)
        rec["bench"].append(b)
        say(f"[serving bench] bf16 {label}: {b['value']} fps ({b['metric']}"
            f"), launches {b['launches']} ({b['held_s']:.1f} s; {smi})")
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "smoke_out"),
                    help="directory for chip_smoke.json and the .bin files")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA device", file=sys.stderr)
        return 1
    from vcm_ts_tpu_torch.ops import cuda_build
    from vcm_ts_tpu_torch.utils.device import set_codec_numerics
    from vcm_ts_tpu_torch.utils.precision import cast_params
    from vcm_ts_tpu_torch.utils.weights import make_dmc, make_intra

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say(f"[setup] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t = time.perf_counter()
    cuda_build.build_all()
    say(f"[setup] kernels built in {time.perf_counter() - t:.1f} s")
    for name, log in cuda_build.build_log.items():
        for line in log.splitlines():
            if "registers" in line:
                say(f"[ptxas {name}] {line.strip()}")
    set_codec_numerics()

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = (check_warp(g) + check_subpel_conv1x1(g) + check_relayout(g)
            + check_warp_twopass(g))
    for r in rows:
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        extra = ("" if r["name"] != "warp_twopass" else
                 f" exact_warp_ms {r['exact_warp_ms']:.4f} grid_sample_ms "
                 f"{r['grid_sample_ms']:.4f} |flow|>D share "
                 f"{r['flow_beyond_d']:.2f}")
        if "per_frame" in r:
            extra += " launches per frame (P enc / P dec / I dec) " + \
                " / ".join(map(str, r["per_frame"]))
        lib_e = ("" if r["library_eager_ms"] is None
                 else f" (eager {r['library_eager_ms']:.4f})")
        say(f"[kernel] {r['name']} {r['shape']}: kernel_ms {r['ms']:.4f} "
            f"(eager {r['eager_ms']:.4f}) plain_ms {r['plain_ms']:.4f} "
            f"library_ms {lib}{lib_e} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) max_abs_err "
            f"{r['max_abs_err']:.3g} (tol {r['tol']:.3g}){extra}")

    t = time.perf_counter()
    intra, dmc = make_intra("cuda"), make_dmc("cuda")
    ref = small_reference(intra, dmc)
    say(f"[reference] 64x64 CPU vs GPU: {ref} "
        f"({time.perf_counter() - t:.1f} s)")

    benches = []
    common = ["--size", f"{H}x{W}", "--frames", "3", "--warmup", "2",
              "--runs", "1", "--estimate-only"]
    for label, extra in (("bf16 fast-warp", ["--fast-warp"]),
                         ("bf16", []), ("f32", []), ("mixed", [])):
        b = run_bench(label, common + ["--dtype", label.split()[0], *extra])
        benches.append(b)
        say(f"[bench] {label}: {b['value']} fps (estimation, {W}x{H}), "
            f"launches {b['launches']} ({b['held_s']:.1f} s)")

    out_dir = args.out
    os.makedirs(out_dir, exist_ok=True)
    gops = []
    intra16 = cast_params(make_intra("cuda"), torch.bfloat16)
    dmc16 = cast_params(make_dmc("cuda", fast_warp=True), torch.bfloat16)
    for tag, models, expect in (
            ("f32", (intra, dmc), {"warp", "subpel_conv1x1",
                                   "pixel_shuffle_relayout"}),
            ("bf16_fast_warp", (intra16, dmc16),
             {"warp_twopass", "subpel_conv1x1", "pixel_shuffle_relayout"})):
        t = time.perf_counter()
        gop = run_gop(*models, out_dir, tag, expect)
        gops.append(gop)
        say(f"[gop {tag}] I+{gop['frames'] - 1}P {W}x{H}: encode "
            f"{gop['encode_fps']:.3f} fps, decode {gop['decode_fps']:.3f} fps, "
            f"bin bytes {gop['bin_bytes']}, PSNR {gop['psnr_db']}, decoded == "
            f"encoder recon on every frame ({time.perf_counter() - t:.1f} s)")
        say(f"[gop {tag}] launches {gop['launches']}")
        for label, p in gop["profile"].items():
            top = ", ".join(f"{k['name'][:40]} {k['ms']:.1f} ms "
                            f"x{k['launches']}" for k in p["top_kernels"][:5])
            say(f"[profile {tag}] P-frame {label}: wall {p['wall_ms']:.1f} ms,"
                f" device busy {p['device_busy_ms']:.1f} ms, idle share "
                f"{p['idle_share']:.3f}; top: {top}")
            ours = ", ".join(f"{k} {v['ms']:.3f} ms x{v['launches']}"
                             for k, v in p["port_kernels"].items())
            say(f"[profile {tag}] P-frame {label}: port kernels: {ours}")

    t = time.perf_counter()
    batched = check_kernels_batched(g)
    say(f"[serving] kernels at N=2, each row == its N=1 launch bit for bit: "
        f"{', '.join(batched)} ({time.perf_counter() - t:.1f} s; {smi})")
    serving = run_serving(intra, dmc, intra16, dmc16, smi)

    # one entry per kernel: its first (main-path) shape, and its launches
    # summed over the main paths, the two GOPs and the two batched serving
    # runs (each read with the counts reset just before it)
    paths = gops + serving["batch"]
    kernels = []
    for name in ("warp", "subpel_conv1x1", "pixel_shuffle_relayout",
                 "warp_twopass"):
        r = next(r for r in rows if r["name"] == name)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(p["launches"][name] for p in paths),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "kernel_rows": rows, "reference": ref,
                   "bench": benches, "gops": gops, "serving": serving,
                   "kernels_batched": batched, "kernels": kernels}, f,
                  indent=1)
    say(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s "
        f"({smi})")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
