"""Smoke run of the PyTorch/CUDA port on one GPU: kernels, bench, GOPs,
serving, the VCM pipeline, training, the eval harness and the training
loop, the perceptual losses and the Faster-RCNN eval detector,
multi-process training and serving, tensor parallelism, the engines'
spatial mode, and the detector and OCR trainers.

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
   line names the card and its power limit;
7. the VCM pipeline (vcm_ts_tpu_torch/codec/vcm_pipeline.py) at
   1088x1920: 3 frames composited from the committed plate and face
   sprites, written with the port's PNG codec, then the base layer (I + 2
   P, f32, exact warp, .bin files), plate and face detection with the
   shipped pretrained/ weights, residuals, the learned enhancement layer,
   fusion and the PSNR report; cold, warm (launches counted, peak memory)
   and warm under the profiler. Gates: every .bin decodes to the
   encoder's recon, each frame has a plate and a face at IoU >= 0.5 to a
   composited box, OCR exact-match >= 0.6 on the source crops, kernels A,
   B and C launched, the fused frames equal base + mask x residual
   recomputed from the files. Then each IntraNoAR conv alone at its
   1088x1920 shape: those whose cuDNN algorithm launches 100 kernels or
   more;
8. training (vcm_ts_tpu_torch/train): kernels A' (the warp's backward),
   C' (k-major space-to-depth) and E' (the bilinear resize's backward)
   against their plain versions, f32 and bf16, at the training step's
   shapes (256x256 crops, batch 4; A' under an iid, a smooth, a zero and
   a converging flow; two calls give the same d flow and d im bit for
   bit; A''s time split into its bucket sort and its accumulate passes
   beside its d flow pass alone; E' at SpyNet's flow upsampling, the
   DMC's 0.5x motion resizes and the perceptual loss's resize to 224, two
   calls bit-equal; beside them the launch floor, an empty kernel replayed
   from a CUDA graph) and one 1088x1920 row of A' and C', beside the
   library call (grid_sampler_2d_backward; pixel_unshuffle + the channel
   permutation; upsample_bilinear2d_backward) and the cuBLAS products of
   kernel B's backward; a 64x64 cascade step of the seeded DMC on the CPU
   and on the card (loss, gradients, parameters after AdamW); the port
   bench's --train-step in f32, --mp and --grad-accum 2 (frames/s, peak
   memory); one cascade step under the profiler (launches counted, A''s
   and E''s share of the device-busy time, gated under 1 %); two cascade
   steps from one state, the same noise, give the same parameters bit for
   bit in f32 and with bf16 compute (--mp), without
   torch.use_deterministic_algorithms (gated; the ops that mode would
   flag are listed); and a gate that the loss on a fixed 256x256 batch
   falls over 20 steps;
9. the codec eval harness at 1088x1920 (a 5-frame moving sequence written
   with the port's PNG codec, the seeded damped IntraNoAR and DMC saved as
   .pth, gop 4, so I P P P I: the I-frame restarts mid-sequence, 4 rate
   points): `vcm_ts_tpu_torch.test_video.main` with
   real streams one rate point after another (launches counted), the same
   with --batch_rates (every .bin and every frame's log equal to the
   sequential run's), entropy-estimated; the decoding sweep's DCVC branch
   (its bits equal the estimated harness's at every rate), benchmark_plot's
   PSNR / MS-SSIM over its frames, bd_rate of the sweep's curve against
   the harness's (and a curve against itself: 0); per rate point wall s,
   I-frame and P-frame ms, bpp, PSNR, MS-SSIM; one rate point under the
   profiler;
10. the training loop: `python -m vcm_ts_tpu_torch.trainer`'s main over a
   PNG tree of 256x256 tiles (8 train and 4 test sequences of 6 frames),
   published widths, 4 anchors, stages me/single, rec/single and
   all/cascade x2, eval and a checkpoint after each epoch (launches
   counted); gates: stages in order, finite losses, eval metrics per
   epoch, every checkpoint loads strict, two runs resumed from the
   cascade stage's first checkpoint repeat every loss of the last epoch
   bit for bit, and a resume with fresh moments differs; frames/s of the
   cascade stage after its
   first epoch, the loader's wait share, eval and checkpoint seconds,
   peak memory;
11. the perceptual losses and the Faster-RCNN eval detector (seeded
   weights: no checkpoint of theirs ships): (a) the ResNet-50, FPN and
   YOLOv8m losses on the card against the CPU at the train step's shape
   (4x256x256) and at 1088x1920 (value rtol 1e-4; d decoded in float64 on
   both devices within 1e-3 of the largest, and the card's f32 d decoded
   within 2e-2 of its float64 one in the 2-norm), ms per call forward and
   forward + backward; (b) phase 8's cascade step with the ResNet loss:
   the 64x64 step card against CPU (phase 8's gate), wall, device-busy,
   launches, the port kernels' launches and peak memory beside phase 8's
   step, whether two such steps from one state give the same parameters
   bit for bit (printed, not a gate), and the loss falling over 20 steps;
   (c) the trainer CLI over
   phase 10's tree with one all/cascade stage marked perceptual
   (frames/s, p_dist > 0); (d) the detector through build_eval_adapter
   on phase 9's 1088x1920 frames: its networks on the card against the
   CPU (within 1e-3 of each output's largest), the two devices'
   detections side by side, ms per frame by stage (backbone, host
   proposals, RoIAlign, box head, host post-processing), pulls per frame,
   and benchmark_plot's rcnn branch over the frames;
12. multi-process training and serving (vcm_ts_tpu_torch/parallel,
   trainer_multi, the harness's rank split, fleet serving), with ranks
   started by parallel/spawn.run_ranks: (a) one NCCL rank (the machine has
   one card; NCCL takes one rank per device) runs phase 8's cascade step
   plain, data parallel and FSDP from one state, each held to the plain
   step with phase 8's card-against-card tolerance (wall ms, peak
   memory); (b) two gloo ranks share the card (gloo stages CUDA tensors
   through the host): whether gloo takes CUDA tensors in FSDP's
   collectives (reduce_scatter_tensor, all_gather_into_tensor), then the
   DP (and, if it does, FSDP) step on 4 rows each against one process on
   the 8 global rows, and the ms of the gradient all-reduce (host-staged
   gloo, not a scaling figure); trainer_multi's main over phase 10's tree
   (all/cascade x2; frames/s, rank 0's checkpoints load strict);
   test_video's main over phase 9's frames with 2 rate points split over
   the ranks (every .bin equal to phase 9's one-process run); (c) an I +
   P batch at N = 2 through fleet codecs over ["cuda:0", "cuda:0"]
   against the unsharded batch. The ranks' launches join the kernels
   line;
13. tensor parallelism (parallel/tensor.py's column-parallel split): (a)
   kernels B and C at the slices of every main-path site that a model
   axis of 2 and of 4 gives each rank (B's narrow path included), f32 and
   bf16, against their plain versions, with device times and bounds; (b)
   two gloo ranks sharing the card split the seeded IntraNoAR and DMC
   (published widths) over a 1 x 2 data x model mesh: each rank's
   parameter and Adam-moment bytes against the whole model's, the
   forwards at 256x256 and phase 8's cascade step, each held to the
   unsharded run on the card (the forwards' bpp rtol 1e-3 and image
   within 1e-3 of its largest; the step with phase 8's card-against-card
   tolerance), their walls and the collectives per step: host-staged
   gloo, not a TP speed; after the step both ranks hold bit-equal whole
   parameters and Adam moments (gated), and how far their own gradients
   of the unsplit parameters were apart before model rank 0's broadcast
   is printed. The ranks' launches join the kernels line;
14. the engines' spatial mode (parallel/spatial.py, set_spatial_sharding):
   (a) kernels A and D with a row window at 1088x1920 (every rank's
   window of the packed f32 warp on 2 ranks and of the 64-channel bf16
   two-pass warp on 4) equal the rows of their whole launch bit for bit,
   one window timed beside its plain version and bound; (b) 2 gloo ranks
   sharing the card code the seeded IntraNoAR and DMC (published widths)
   at 1088x1920 in f32, I + 2 P, the P chain from the unsharded engine's
   I recon: the I-frame and first P-frame streams equal the unsharded
   engine's, the split decoder decodes the unsharded streams (recon drift
   printed), each P-frame decodes to the encoder's recon bit for bit, all
   ranks write the same bytes, and the planes that do not tile the ranks
   (hooked: the hyper encoders' H/64 outputs) are whole and bit-equal on
   every rank; (c) 4 gloo ranks, 576x1024 bf16 fast_warp, I + 1 P (H/16
   slices of 9 rows, H/32 and H/64 whole): the same within-mode gates,
   and whether the streams equal the unsharded ones is printed. Wall per
   call against the unsharded engine, collectives per call, launches per
   rank (host-staged gloo: no NCCL or multi-GPU figure). The ranks'
   launches join the kernels line;
15. detector training (vcm_ts_tpu_torch/train_plate_ocr.py,
   train_plate_detector.py, train_face_detector.py; no hand-written
   kernel on this path): each trainer's step at its published size (OCR
   batch 64 at width 160, YOLOv8-n batch 8 at 320x320, P/R/O-Net 32 crops
   each), TF32 off: 30 steps on one fixed batch must halve the loss; two
   steps from one state with the same batch give the same parameters,
   buffers and Adam moments bit for bit; torch.use_deterministic_
   algorithms(True, warn_only=True) flags no op of a step; over a
   synthesise-and-step loop under the profiler, wall ms per step, device
   busy ms and launches per step, host synthesis ms per batch and the
   device's idle share; the card CTC (the
   forward-backward route of train/ctc.py) against its plain version on
   the card in loss and d logits; each trained model exported
   to a temporary directory, loaded back bit-equal through the port's
   loaders, and run through build_lp_adapter, build_face_adapter and the
   OCR on a synthesised scene.

Each phase's seconds are printed as it ends ([phase N ...] lines) and
kept in chip_smoke.json ("phase_s"). The last three lines of standard output are the `kernels` JSON object, the
nvidia-smi line, and then {"ok": true, "device": {...}}. A longer record
(chip_smoke.json) and the GOPs' .bin files go to --out (default
smoke_out/ in the repo). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
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
    "warp_bwd": "vcm_ts_tpu/ops/warp.py:49 (_warp_one_gather's gradient; "
                "XLA autodiff)",
    "space_to_depth": "vcm_ts_tpu/ops/subpel_pallas.py:131 "
                      "(_kmajor_space_to_depth, in _relayout_bwd:149 and "
                      "_conv1x1_bwd:221)",
    "resize_bwd": "vcm_ts_tpu/ops/resize.py:14 (bilinear_up2's gradient: "
                  "XLA's transposed einsum of jax.image.resize; no Pallas "
                  "kernel)",
}
SOURCES = {"warp": "vcm_ts_tpu_torch/csrc/warp.cu",
           "subpel_conv1x1": "vcm_ts_tpu_torch/csrc/subpel_conv1x1.cu",
           "pixel_shuffle_relayout": "vcm_ts_tpu_torch/csrc/pixel_shuffle.cu",
           "warp_twopass": "vcm_ts_tpu_torch/csrc/warp_twopass.cu",
           "warp_bwd": "vcm_ts_tpu_torch/csrc/warp_bwd.cu",
           "space_to_depth": "vcm_ts_tpu_torch/csrc/space_to_depth.cu",
           "resize_bwd": "vcm_ts_tpu_torch/csrc/resize_bwd.cu"}
# the __global__ functions of csrc/*.cu, as the profiler names them
PORT_KERNEL_FUNCS = ("warp_kernel", "warp_narrow_kernel", "warp_twopass_kernel",
                     "conv_mma_bf16", "conv_fma_f32", "conv_narrow",
                     "relayout_kernel", "warp_bwd_kernel", "warp_bwd_hist",
                     "warp_bwd_scan", "warp_bwd_scatter", "warp_bwd_bounds",
                     "warp_bwd_plan", "warp_bwd_accumulate",
                     "warp_bwd_finalize",
                     "s2d_kernel", "resize_bwd_kernel")
# kernel A''s passes (csrc/warp_bwd.cu: the d flow pass alone; the bucket
# sort and the tiles' plan; the accumulate pass and its finalize) and
# kernel E''s, by profiler name
A_BWD_FUNCS = ("warp_bwd_kernel", "warp_bwd_hist", "warp_bwd_scan",
               "warp_bwd_scatter", "warp_bwd_bounds", "warp_bwd_plan",
               "warp_bwd_accumulate", "warp_bwd_finalize")
E_BWD_FUNCS = ("resize_bwd_kernel",)
# the kernels every training path launches (A, A', B, C, C', E'; not D)
TRAIN_KERNELS = ("warp", "warp_bwd", "subpel_conv1x1",
                 "pixel_shuffle_relayout", "space_to_depth", "resize_bwd")
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
def _grid(flow, row0=0, h=None):
    """F.grid_sample's grid for a pixel flow (align_corners=True); with a
    row window, for the flow's rows from row0 of an image of h rows."""
    _, _, hl, w = flow.shape
    h = hl if h is None else h
    ys, xs = torch.meshgrid(torch.arange(row0, row0 + hl,
                                         device=flow.device),
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
    """fn() under torch.profiler (device activity): wall ms, device-busy ms
    (the sum of kernel and copy times), the idle share, the launches, the
    kernels that take the most device time and the port's kernels' sums.
    Summed from the raw trace events: building torch's Python event list
    took minutes for the VCM phase's ~800 000 launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
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
            "launches": sum(n for _, n in by_name.values()),
            "top_kernels": [{"name": k[:160], "ms": v[0], "launches": v[1]}
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



# ------------------------------------------------------------------ phase 7
SPRITES = os.path.join(ROOT, "vcm_ts_tpu_torch", "eval", "data",
                       "smoke_sprites.npz")
# plate widths and face size at 1920 wide: 6x the sizes that
# tests/test_vcm_e2e_learned.py composites at 256x192 (a 90 px plate, a 56 px
# face), so that after the detector's letterbox to 320 they are as large as
# in its training; top-left corners at 1088x1920
PLATE_W = (420, 540, 480, 360)
PLATE_XY = ((120, 150), (1250, 120), (200, 760), (1300, 820))
FACE_S = 336
FACE_XY = ((800, 150), (800, 640))
VCM_FRAMES, VCM_GOP, VCM_SHIFT = 3, 3, 4
Q_ANCHORS = (1.2, 0.9, 0.7, 0.5)  # the rate anchors written into the .pth
VCM_SETTINGS = dict(rate_count=4, quality=1, lp_prob=0.5, lp_pad=2,
                    fc_prob=0.7, fc_pad=2, enh_quality=3)


def compose_frames(n, h, w, seed=0):
    """n RGB uint8 frames: a seeded background with the committed plate and
    face sprites (vcm_ts_tpu_torch/eval/data/smoke_sprites.npz, rendered by
    tools/train_plate_ocr.render_plate and tools/train_face_detector
    .render_face) pasted with numpy, moving VCM_SHIFT pixels right per
    frame; sizes and places scale with w / 1920. Returns (frames, plate
    boxes, face boxes, plate texts)."""
    from vcm_ts_tpu_torch.ops.cv_resize import resize_linear_u8

    sp = dict(np.load(SPRITES))
    s = w / 1920
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, h)[:, None, None]
    bg = (rng.integers(60, 200, 3) * (1 - t) + rng.integers(30, 140, 3) * t
          ) * np.ones((1, w, 1))
    for _ in range(8):
        x, y = rng.integers(0, w - w // 6), rng.integers(0, h - h // 5)
        bw, bh = rng.integers(w // 19, w // 4), rng.integers(h // 18, h // 4)
        bg[y:y + bh, x:x + bw] = rng.integers(20, 230, 3)
    bg += rng.normal(0, 4, bg.shape)
    plates = []
    for i, pw in enumerate(PLATE_W):
        p = sp[f"plate{i}"]
        pw = round(pw * s)
        ph = round(p.shape[0] * pw / p.shape[1])
        plates.append(resize_linear_u8(torch.from_numpy(p[:, :, None]), ph,
                                       pw).numpy())
    fs = round(FACE_S * s)
    faces = [resize_linear_u8(torch.from_numpy(sp[f"face{i}"]), fs,
                              fs).numpy().astype(np.float64)
             for i in range(2)]
    frames, lp_boxes, fc_boxes = [], [], []
    for k in range(n):
        img = bg.copy()
        lp, fc = [], []
        for (x, y), p in zip(PLATE_XY, plates):
            x, y = round(x * s) + VCM_SHIFT * k, round(y * s)
            img[y:y + p.shape[0], x:x + p.shape[1]] = p
            lp.append([x, y, x + p.shape[1], y + p.shape[0]])
        for (x, y), f in zip(FACE_XY, faces):
            x, y = round(x * s) + VCM_SHIFT * k, round(y * s)
            a = f[:, :, 3:] / 255.0
            img[y:y + fs, x:x + fs] = (img[y:y + fs, x:x + fs] * (1 - a)
                                       + f[:, :, :3] * a)
            fc.append([x, y, x + fs, y + fs])
        frames.append(img.clip(0, 255).astype(np.uint8))
        lp_boxes.append(np.asarray(lp, np.float32))
        fc_boxes.append(np.asarray(fc, np.float32))
    return frames, lp_boxes, fc_boxes, [str(t) for t in sp["texts"]]


def save_codec_pth(model, path):
    """A port codec's weights as a reference-layout .pth, with decreasing
    rate anchors (Q_ANCHORS) in its q-scale parameters."""
    sd = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    for k in ("q_scale", "y_q_scale", "mv_y_q_scale"):
        if k in sd:
            sd[k] = torch.tensor(Q_ANCHORS).reshape(-1, 1, 1, 1)
    torch.save(sd, path)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def vcm_pipeline(root, ckpt, device):
    """The port's VCM pipeline over root/artifacts/source_frames, stage by
    stage (codec/vcm_pipeline.py, the flow of video_coder.py with the
    learned enhancement layer); wall ms per stage."""
    from vcm_ts_tpu_torch.codec import vcm_pipeline as vp

    cfg = VCM_SETTINGS
    j = os.path.join
    stages = (
        ("base layer", lambda: vp.encode_decode_dcvc(
            j(root, vp.PATHS_ARTIFACTS_SOURCE_FRAMES), ckpt["i"], ckpt["p"],
            anchor_num=4, gop=VCM_GOP, rate_count=cfg["rate_count"],
            quality=cfg["quality"], write_stream=True,
            out_frames_dir=j(root, vp.PATHS_ARTIFACTS_DCVC_HEM),
            out_bins_dir=j(root, vp.PATHS_ENCODED_DIR, "dcvc_hem_bins"),
            device=device)),
        ("detect plates", lambda: vp.detect_rois(
            root, "liplates", prob=cfg["lp_prob"], padding=cfg["lp_pad"],
            device=device)),
        ("detect faces", lambda: vp.detect_rois(
            root, "faces", prob=cfg["fc_prob"], padding=cfg["fc_pad"],
            device=device)),
        ("residuals", lambda: vp.compute_residuals(
            root, True, True, j(root, vp.PATHS_ARTIFACTS_RESIDUALS),
            device=device)),
        ("learned enhancement layer", lambda: vp.encode_residuals_learned(
            root, ckpt["i"], cfg["enh_quality"],
            j(root, vp.PATHS_ARTIFACTS_RESIDUALS_ENCODED),
            rate_count=cfg["rate_count"], device=device)),
        ("fuse", lambda: vp.fuse_layers(
            root, faces_padding=cfg["fc_pad"],
            liplates_padding=cfg["lp_pad"], device=device)),
        ("visual metrics", lambda: vp.calc_visual_metrics(
            root, "source_frames", liplates_padding=cfg["lp_pad"],
            faces_padding=cfg["fc_pad"], device=device)),
    )
    ms, out = {}, None
    for name, fn in stages:
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        ms[name] = (time.perf_counter() - t0) * 1e3
    return ms, out


def _bins(folder):
    return sorted(os.path.join(folder, f) for f in os.listdir(folder))


def check_vcm_streams(root, ckpt, frames, device):
    """Every base and enhancement .bin, read back from disk and decoded,
    equals the encoder's recon: fresh codecs from the same .pth code the
    same inputs into the same bytes, the decoded frames equal the
    encoder's (the I-frame's decode, each P-frame's DPB) bit for bit, and
    the decoded PNGs the pipeline wrote are those recons."""
    from vcm_ts_tpu_torch.codec import bitstream as bs
    from vcm_ts_tpu_torch.codec import vcm_pipeline as vp
    from vcm_ts_tpu_torch.codec.engine import VideoCodec
    from vcm_ts_tpu_torch.codec.png_io import imread
    from vcm_ts_tpu_torch.models.dmc import make_dpb

    cfg = VCM_SETTINGS
    ic, i_sc = vp.load_intra_codec(ckpt["i"], cfg["rate_count"],
                                   device=device)
    dmc, y_q, mv_q = vp.load_video_model(ckpt["p"], 4, device)
    vc = VideoCodec(dmc, device=device)
    vc.update(force=True)
    iq = bs.get_rounded_q(float(i_sc[cfg["quality"]]))[0]
    yq = bs.get_rounded_q(float(vp._q_ladder(y_q, cfg["rate_count"])
                                [cfg["quality"]]))[0]
    mq = bs.get_rounded_q(float(vp._q_ladder(mv_q, cfg["rate_count"])
                                [cfg["quality"]]))[0]

    def png_of(x):
        return (x[0].clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy()

    h, w = frames[0].shape[:2]
    base = _bins(os.path.join(root, vp.PATHS_ENCODED_DIR, "dcvc_hem_bins"))
    pngs = sorted(os.listdir(os.path.join(root, vp.PATHS_ARTIFACTS_DCVC_HEM)))
    checked = 0
    enc_dpb = dec_dpb = None
    for t, (path, x) in enumerate(zip(base, frames)):
        xt = torch.from_numpy(bs.pad_image(x[None].astype(np.float32)
                                           / 255.0)).to(device)
        if t % VCM_GOP == 0:
            _, _, qi, stream = bs.decode_i(path)
            if ic.compress(xt, iq) != stream or qi != round(iq * 100):
                raise AssertionError(f"vcm: {path} differs from the I-frame "
                                     "coded again")
            rec = ic.decompress(stream, h, w, qi / 100).clamp(0, 1)
            enc_dpb = dec_dpb = make_dpb(rec)
            dec = rec
        else:
            _, _, stream = bs.decode_p(path)
            enc = vc.compress(xt, enc_dpb, mq, yq, t % VCM_GOP == 1)
            if enc["bit_stream"] != stream:
                raise AssertionError(f"vcm: {path} differs from the P-frame "
                                     "coded again")
            d = vc.decompress(dec_dpb, stream, h, w, mq, yq,
                              t % VCM_GOP == 1)["dpb"]
            if not torch.equal(d["ref_frame"], enc["dpb"]["ref_frame"]):
                raise AssertionError(f"vcm: {path} decodes to another frame "
                                     "than the encoder's DPB recon")
            enc_dpb = dict(enc["dpb"], ref_frame=enc["dpb"]["ref_frame"]
                           .clamp(0, 1))
            dec_dpb = dict(d, ref_frame=d["ref_frame"].clamp(0, 1))
            dec = dec_dpb["ref_frame"]
        png = imread(os.path.join(root, vp.PATHS_ARTIFACTS_DCVC_HEM,
                                  pngs[t]))
        if not np.array_equal(png_of(dec[:, :h, :w]), png):
            raise AssertionError(f"vcm: decoded base frame {t} != its PNG")
        checked += 1
    eq = bs.get_rounded_q(float(i_sc[cfg["enh_quality"]]))[0]
    enh = _bins(os.path.join(root, vp.PATHS_ENCODED_DIR, "enhancement_bins"))
    res_dir = os.path.join(root, vp.PATHS_ARTIFACTS_RESIDUALS)
    dec_dir = os.path.join(root, vp.PATHS_ARTIFACTS_RESIDUALS_ENCODED)
    for path, name in zip(enh, sorted(os.listdir(res_dir))):
        hh, ww, qi, stream = bs.decode_i(path)
        # coded in BGR order (encode_residuals_learned)
        res = imread(os.path.join(res_dir, name))[:, :, ::-1].astype(
            np.float32) / 255.0
        xt = torch.from_numpy(bs.pad_image(res[None])).to(device)
        if ic.compress(xt, eq) != stream:
            raise AssertionError(f"vcm: {path} differs from the residual "
                                 "coded again")
        rec = ic.decompress(stream, hh, ww, qi / 100)[:, :hh, :ww].flip(-1)
        if not np.array_equal(png_of(rec), imread(os.path.join(dec_dir,
                                                               name))):
            raise AssertionError(f"vcm: {path} decodes to another residual "
                                 "than the pipeline wrote")
        checked += 1
    if checked != 2 * len(frames):
        raise AssertionError(f"vcm: {checked} streams for {len(frames)} "
                             "frames")
    return checked


def check_vcm_fusion(root, pads):
    """Each fused frame equals base + mask x (residual - 128), clipped and
    truncated, recomputed in numpy from the files (the JAX package's
    arithmetic, create_gradient_mask)."""
    import pickle

    from vcm_ts_tpu_torch.codec import vcm_pipeline as vp
    from vcm_ts_tpu_torch.codec.png_io import imread

    j = os.path.join
    names = sorted(os.listdir(j(root, vp.PATHS_ARTIFACTS_RESULT)))
    for i, name in enumerate(names):
        b = imread(j(root, vp.PATHS_ARTIFACTS_DCVC_HEM, name)).astype(
            np.float32)
        e = imread(j(root, vp.PATHS_ARTIFACTS_RESIDUALS_ENCODED, name)
                   ).astype(np.float32) - 128
        h, w, _ = b.shape
        mask = np.zeros((h, w, 1), np.float32)
        for kind in ("liplates", "faces"):
            files = sorted(os.listdir(j(root, vp.PATHS_ENCODED_DIR,
                                        f"{kind}_coords")))
            with open(j(root, vp.PATHS_ENCODED_DIR, f"{kind}_coords",
                        files[i]), "rb") as f:
                for x1, y1, x2, y2 in pickle.load(f).reshape(-1, 4):
                    mask[y1:y2, x1:x2] = vp.create_gradient_mask(
                        w=x2 - x1, h=y2 - y1, border_size=pads[kind])
        want = np.clip(b + mask * e, 0, 255).astype(np.uint8)
        if not np.array_equal(imread(j(root, vp.PATHS_ARTIFACTS_RESULT,
                                       name)), want):
            raise AssertionError(f"vcm: fused frame {name} != base + mask x "
                                 "residual")
    return len(names)


def _iou_hits(root, gts, folder_kind):
    """Per frame: how many composited boxes have a pipeline box at
    IoU >= 0.5 (the pickled coords, padding included)."""
    import pickle

    from vcm_ts_tpu_torch.codec import vcm_pipeline as vp
    from vcm_ts_tpu_torch.eval.detection_metrics import box_iou

    folder = os.path.join(root, vp.PATHS_ENCODED_DIR, f"{folder_kind}_coords")
    hits, ious = [], []
    for f, gt in zip(sorted(os.listdir(folder)), gts):
        with open(os.path.join(folder, f), "rb") as fh:
            boxes = pickle.load(fh).reshape(-1, 4).astype(np.float64)
        iou = box_iou(gt.astype(np.float64), boxes)
        best = iou.max(1) if iou.size else np.zeros(len(gt))
        hits.append(int((best >= 0.5).sum()))
        ious.append([round(float(v), 3) for v in best])
    return hits, ious


def intra_conv_launches():
    """Each conv of the IntraNoAR (seeded damped) at the shape a 1088x1920
    I-frame coded and decoded gives it, run alone under the profiler: the
    convs whose cuDNN algorithm launches 100 kernels or more, with their
    device ms and their most frequent kernel."""
    from vcm_ts_tpu_torch.codec.engine import IntraCodec
    from vcm_ts_tpu_torch.utils.weights import make_intra

    ic = IntraCodec(make_intra("cuda"), device="cuda")
    ic.update()
    seen = {}
    names = {m: n for n, m in ic.model.named_modules()}

    def record(m, inputs, _):  # returns None: the output is kept
        seen.setdefault((names[m], tuple(inputs[0].shape)), (m, inputs[0]))

    hooks = [m.register_forward_hook(record) for m in ic.model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    x = torch.rand((1, H, W, 3), device="cuda")
    ic.decompress(ic.compress(x, IQ), H, W, IQ)
    for hk in hooks:
        hk.remove()
    rows = []
    with torch.no_grad():
        for (name, shape), (m, x_in) in seen.items():
            x_in = x_in.clone()
            p = profile_ms(lambda: m(x_in))
            n = p["launches"]
            if n >= 100:
                top = p["top_kernels"][0]
                rows.append({"conv": name, "input": list(shape),
                             "device_ms": p["device_busy_ms"],
                             "launches": n, "top_kernel": top["name"][:90],
                             "top_launches": top["launches"]})
    return rows


def run_vcm(out_dir, smi):
    """Phase 7: the VCM pipeline at 1088x1920 on the card (cold, then warm
    with launches counted, then warm under the profiler), with its gates."""
    from vcm_ts_tpu_torch.codec import vcm_pipeline as vp
    from vcm_ts_tpu_torch.codec.png_io import imread, read_png, write_png
    from vcm_ts_tpu_torch.eval.detection_metrics import MeanAveragePrecision
    from vcm_ts_tpu_torch.eval.ocr_native import PlateOCRNative
    from vcm_ts_tpu_torch.eval.yolo_native import YOLOv8NativeDetector
    from vcm_ts_tpu_torch.ops import cuda_build
    from vcm_ts_tpu_torch.utils.weights import make_dmc, make_intra

    device = "cuda"
    root = os.path.join(out_dir, "vcm")
    shutil.rmtree(root, ignore_errors=True)
    src = os.path.join(root, vp.PATHS_ARTIFACTS_SOURCE_FRAMES)
    os.makedirs(src)
    frames, lp_gt, fc_gt, texts = compose_frames(VCM_FRAMES, H, W)
    png = {}
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        write_png(os.path.join(src, f"im{i + 1:05d}.png"), f)
    png["write_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / len(frames)
    t0 = time.perf_counter()
    back = imread(os.path.join(src, "im00001.png"))
    png["read_ms_up_filter"] = (time.perf_counter() - t0) * 1e3
    paeth = os.path.join(root, "paeth.png")
    write_png(paeth, frames[0], filter_type=4)
    t0 = time.perf_counter()
    back4 = read_png(paeth)
    png["read_ms_paeth_filter"] = (time.perf_counter() - t0) * 1e3
    os.remove(paeth)
    if not (np.array_equal(back, frames[0])
            and np.array_equal(back4, frames[0])):
        raise AssertionError("vcm: a PNG read back differs from its frame")

    ckpt = {"i": os.path.join(root, "intra.pth"),
            "p": os.path.join(root, "dmc.pth")}
    save_codec_pth(make_intra(device), ckpt["i"])
    save_codec_pth(make_dmc(device), ckpt["p"])

    runs = {}
    ms, _ = vcm_pipeline(root, ckpt, device)
    runs["cold"] = ms
    fused_cold = [imread(os.path.join(root, vp.PATHS_ARTIFACTS_RESULT, n))
                  for n in sorted(os.listdir(os.path.join(
                      root, vp.PATHS_ARTIFACTS_RESULT)))]
    cuda_build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ms, metrics = vcm_pipeline(root, ckpt, device)
    launches = dict(cuda_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    runs["warm"] = ms
    prof = profile_ms(lambda: vcm_pipeline(root, ckpt, device))
    for i, n in enumerate(sorted(os.listdir(os.path.join(
            root, vp.PATHS_ARTIFACTS_RESULT)))):
        if not np.array_equal(fused_cold[i], imread(os.path.join(
                root, vp.PATHS_ARTIFACTS_RESULT, n))):
            raise AssertionError("vcm: a second run fused other frames")

    n_streams = check_vcm_streams(root, ckpt, frames, device)
    n_fused = check_vcm_fusion(root, {"liplates": VCM_SETTINGS["lp_pad"],
                                      "faces": VCM_SETTINGS["fc_pad"]})
    lp_hits, lp_iou = _iou_hits(root, lp_gt, "liplates")
    fc_hits, fc_iou = _iou_hits(root, fc_gt, "faces")
    if min(lp_hits) < 1 or min(fc_hits) < 1:
        raise AssertionError(f"vcm: a frame without a plate or a face at "
                             f"IoU >= 0.5: plates {lp_iou}, faces {fc_iou}")
    missing = [k for k in ("warp", "subpel_conv1x1",
                           "pixel_shuffle_relayout") if not launches[k]]
    if missing:
        raise AssertionError(f"vcm: kernels {missing} not launched: "
                             f"{launches}")

    ocr = PlateOCRNative.load(os.path.join(vp.PRETRAINED, "plate_ocr.npz"),
                              device=device)
    fused = sorted(os.listdir(os.path.join(root, vp.PATHS_ARTIFACTS_RESULT)))
    exact = {"source": [], "fused": []}
    read = {"source": [], "fused": []}
    for i, f in enumerate(frames):
        for kind, img in (("source", f), ("fused", imread(os.path.join(
                root, vp.PATHS_ARTIFACTS_RESULT, fused[i])))):
            got = ocr(torch.from_numpy(img).to(device).float() / 255.0,
                      lp_gt[i])
            read[kind].append(got)
            exact[kind] += [g == t for g, t in zip(got, texts)]
    ocr_src = float(np.mean(exact["source"]))
    ocr_fused = float(np.mean(exact["fused"]))
    if ocr_src < 0.6:
        raise AssertionError(f"vcm: OCR exact-match on source crops "
                             f"{ocr_src} < 0.6: {read['source']} vs {texts}")

    det = YOLOv8NativeDetector.load(os.path.join(vp.PRETRAINED,
                                                 "yolov8-lp.npz"),
                                    device=device)
    mean_ap = MeanAveragePrecision()
    for f, gt in zip(frames, lp_gt):
        boxes, scores, labels = det.detect(torch.from_numpy(f).to(device),
                                           conf=0.25)
        mean_ap.update({"boxes": boxes, "scores": scores,
                        "labels": labels.astype(np.int64)},
                       {"boxes": gt, "labels": np.zeros(len(gt), np.int64)})
    map50 = mean_ap.compute()["map_50"]

    j = os.path.join
    pix = len(frames) * H * W
    bpp = {"base": 8 * vp.get_dir_size(j(root, vp.PATHS_ENCODED_DIR,
                                         "dcvc_hem_bins")) / pix,
           "enhancement": vp._enhancement_layer_bits(root) / pix}
    bpp["total"] = bpp["base"] + bpp["enhancement"]
    # ~100 MB of PNGs and ~100 MB of weights at 1088x1920
    shutil.rmtree(j(root, "artifacts"))
    for path in ckpt.values():
        os.remove(path)
    wall = sum(runs["warm"].values())
    return {"frames": len(frames), "height": H, "width": W,
            "stage_ms": runs, "warm_wall_ms": wall,
            "fps": len(frames) * 1e3 / wall, "png": png,
            "profile": prof, "peak_bytes": peak, "launches": launches,
            "launches_per_frame": {k: v / len(frames)
                                   for k, v in launches.items()},
            "bpp": bpp, "psnr": metrics, "ocr_exact": {
                "source": ocr_src, "fused": ocr_fused},
            "ocr_read": read, "texts": texts, "map50": map50,
            "plate_hits": lp_hits, "plate_iou": lp_iou,
            "face_hits": fc_hits, "face_iou": fc_iou,
            "streams_checked": n_streams, "fused_checked": n_fused,
            "device": smi}


def say_vcm(v, held_s, smi):
    tag = f"[vcm] {v['frames']} frames {v['width']}x{v['height']}"
    for run in ("cold", "warm"):
        say(f"{tag} {run} stage wall ms: "
            + ", ".join(f"{k} {x:.1f}" for k, x in v["stage_ms"][run].items())
            + f" ({smi})")
    say(f"{tag} warm pipeline {v['warm_wall_ms']:.1f} ms, {v['fps']:.3f} fps;"
        f" peak {v['peak_bytes'] / 2**30:.2f} GiB ({smi})")
    p = v["profile"]
    say(f"{tag} profiled run: wall {p['wall_ms']:.1f} ms, device busy "
        f"{p['device_busy_ms']:.1f} ms, device-busy share "
        f"{1 - p['idle_share']:.3f}; top: " + ", ".join(
            f"{k['name'][:100]} {k['ms']:.1f} ms x{k['launches']}"
            for k in p["top_kernels"][:4]) + f" ({smi})")
    say(f"{tag} launches (warm run) {v['launches']}, per frame "
        + ", ".join(f"{k} {x:g}" for k, x in v["launches_per_frame"].items())
        + f" ({smi})")
    say(f"{tag} bpp base {v['bpp']['base']:.6f}, enhancement "
        f"{v['bpp']['enhancement']:.6f}, total {v['bpp']['total']:.6f}; PSNR "
        f"total {v['psnr']['total_psnr']:.4f} dB, base "
        f"{v['psnr']['base_psnr']:.4f} dB, ROI {v['psnr']['roi_psnr']:.4f} dB"
        f" (random damped codecs: not gated; {smi})")
    say(f"{tag} OCR exact-match source {v['ocr_exact']['source']:.3f}, fused "
        f"{v['ocr_exact']['fused']:.3f} (texts {v['texts']}, source reads "
        f"{v['ocr_read']['source']}); plate mAP50 {v['map50']:.4f}; plates "
        f"at IoU>=0.5 per frame {v['plate_hits']} {v['plate_iou']}, faces "
        f"{v['face_hits']} {v['face_iou']} ({smi})")
    say(f"{tag} PNG codec: write {v['png']['write_ms_per_frame']:.1f} ms per "
        f"frame, read {v['png']['read_ms_up_filter']:.1f} ms (Up filter), "
        f"{v['png']['read_ms_paeth_filter']:.1f} ms (Paeth filter) (host of "
        f"{smi})")
    say(f"{tag} {v['streams_checked']} .bin files decode to the encoder's "
        f"recon, {v['fused_checked']} fused frames == base + mask x residual "
        f"({held_s:.1f} s; {smi})")

# ------------------------------------------------------------------ phase 8
TH, TW, TN = 256, 256, 4  # the training crops and batch (bench.py)
# Kernel A' at the cascade step's warp sites (batch 4 at 256x256), and one
# 1088x1920 row: (label, channels of each tensor, N, H, W).
WARP_BWD_SHAPES = (
    ("67ch packed (3+64)", (3, 64), TN, TH, TW),
    ("3ch SpyNet level 0", (3,), TN, TH, TW),
    ("3ch SpyNet level 1", (3,), TN, TH // 2, TW // 2),
    ("3ch SpyNet level 2", (3,), TN, TH // 4, TW // 4),
    ("3ch SpyNet level 3", (3,), TN, TH // 8, TW // 8),
    ("64ch context2", (64,), TN, TH // 2, TW // 2),
    ("64ch context3", (64,), TN, TH // 4, TW // 4),
    ("67ch packed (3+64)", (3, 64), 1, H, W),
)
# Kernel C' at every subpel site of the cascade step (the gradient of each
# SubpelConv's output, batch 4 at 256x256; B: the 1x1 sites, C: the 3x3
# ones), one row per shape, and one 1088x1920 row: (sites, C, N, output
# H, W).
S2D_SHAPES = (
    ("UNet up2 (B), contextual decoder up4 (C)", 32, TN, TH, TW),
    ("context fusion conv2_up (C)", 64, TN, TH, TW),
    ("mv decoder last (B)", 2, TN, TH, TW),
    ("mv decoder block 3, UNet up3 (B), fusion conv3_up, contextual "
     "decoder up3 (C)", 64, TN, TH // 2, TW // 2),
    ("mv decoder block 2 (B), contextual decoder up2 (C)", 64, TN, TH // 4,
     TW // 4),
    ("mv decoder block 1 (B), contextual decoder up1 (C)", 64, TN, TH // 8,
     TW // 8),
    ("mv hyper decoder (B)", 96, TN, TH // 16, TW // 16),
    ("contextual hyper decoder (B)", 144, TN, TH // 16, TW // 16),
    ("contextual hyper decoder (B)", 96, TN, TH // 32, TW // 32),
    ("mv hyper decoder (B)", 64, TN, TH // 32, TW // 32),
    ("1088x1920", 64, 1, H, W),
)


def _bf16_or_f32_tol(want, dtype, f32_rel):
    """f32: f32_rel of the largest magnitude; bf16: one bf16 ulp of it
    (both versions cast an f32 sum once)."""
    scale = float(want.float().abs().max())
    return (f32_rel if dtype == torch.float32 else 2.0 ** -7) * scale


def converge_flow(n, h, w):
    """Every output onto one interior pixel (half down, a third across, at
    a fraction): one bucket of h * w outputs a plane, the worst skew."""
    ys = torch.arange(h, device="cuda", dtype=torch.float32)
    xs = torch.arange(w, device="cuda", dtype=torch.float32)
    f = torch.stack([(w // 3 + 0.25 - xs)[None, :].expand(h, w),
                     (h // 2 + 0.5 - ys)[:, None].expand(h, w)])
    return f[None].repeat(n, 1, 1, 1)


def pass_ms(fn, funcs, once="warp_bwd_plan"):
    """Device ms of one fn() call spent in each of the kernels named in
    funcs (profiler names): three calls under the profiler after a warm
    one, divided by the launches seen of `once`, a kernel each call
    launches once (the trace can miss a call's kernels)."""
    fn()
    prof = profile_ms(lambda: [fn() for _ in range(3)])
    pk = prof["port_kernels"]
    calls = max(1, pk.get(once, {"launches": 0})["launches"])
    return {f: pk.get(f, {"ms": 0.0})["ms"] / calls for f in funcs}


def check_warp_bwd(g):
    """Kernel A' against warp_backward_plain, f32 and bf16, iid N(0, 8^2),
    smooth, zero and converging flows; d flow within 1e-5 and d im within
    1e-4 of the largest magnitude in f32 (both sum in fixed orders other
    than the plain version's), one bf16 ulp in bf16. Two calls must give
    the same d flow and d im bit for bit. Beside it the parts of a call:
    the bucket sort and the tiles' plan (warp_bwd_hist, _scan, _scatter,
    _bounds, _plan), the accumulate pass (d flow of each tile's outputs,
    then d im; with _finalize for split lists), both for the packed rows,
    and, for comparison, the d flow pass alone (need_im=False); and aten's grid_sampler_2d_backward
    (bilinear, border, align_corners=True: the same function up to the
    clip's 0.5 at a bound) on the concatenated tensor. A converging row
    times the kernel alone (one block sums a whole plane's bucket)."""
    from vcm_ts_tpu_torch.ops import warp as tw

    rows = []
    for name, chans, n, h, w in WARP_BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for kind in ("iid", "smooth", "zero", "converge"):
                ims = [(torch.rand if c == 3 else torch.randn)(
                    (n, c, h, w), device="cuda", generator=g).to(
                        dtype=dtype, memory_format=CL) for c in chans]
                gs = [torch.randn((n, c, h, w), device="cuda",
                                  generator=g).to(dtype=dtype,
                                                  memory_format=CL)
                      for c in chans]
                if kind == "zero":
                    flow = torch.zeros((n, 2, h, w), device="cuda")
                elif kind == "converge":
                    flow = converge_flow(n, h, w)
                else:
                    flow = torch.cat([make_flow(kind, h, w, g)
                                      for _ in range(n)])
                flow = flow.to(dtype=dtype, memory_format=CL)
                dflow, dims = tw.warp_backward_cuda(ims, flow, gs)
                again = tw.warp_backward_cuda(ims, flow, gs)
                wflow, wims = tw.warp_backward_plain(ims, flow, gs)
                err_f = float((dflow.float() - wflow.float()).abs().max())
                err_i = max(float((a.float() - b.float()).abs().max())
                            for a, b in zip(dims, wims))
                tol_f = _bf16_or_f32_tol(wflow, dtype, 1e-5)
                tol_i = max(_bf16_or_f32_tol(b, dtype, 1e-4) for b in wims)
                dt = "f32" if dtype == torch.float32 else "bf16"
                size = f"N={n} {h}x{w}"
                label = f"{name} {size} {dt}, {kind} flow"
                if not (err_f <= tol_f and err_i <= tol_i):
                    raise AssertionError(
                        f"warp_bwd {label}: d flow err {err_f} (tol "
                        f"{tol_f}), d im err {err_i} (tol {tol_i})")
                if not (torch.equal(dflow, again[0])
                        and all(torch.equal(a, b)
                                for a, b in zip(dims, again[1]))):
                    raise AssertionError(f"warp_bwd {label}: two calls on "
                                         "the same inputs differ")
                del again, wims

                def kernel():
                    return tw.warp_backward_cuda(ims, flow, gs)

                if kind == "converge":
                    t = dict(ms=graph_ms(kernel, iters=1), eager_ms=None,
                             plain_ms=None, library_ms=None,
                             library_eager_ms=None)
                else:
                    cat = torch.cat(ims, 1) if len(ims) > 1 else ims[0]
                    gcat = torch.cat(gs, 1) if len(gs) > 1 else gs[0]
                    grid = torch.cat([_grid(flow[i:i + 1].float())
                                      for i in range(n)]).to(dtype)
                    t = times(kernel,
                              lambda: tw.warp_backward_plain(ims, flow, gs),
                              lambda: torch.ops.aten.grid_sampler_2d_backward(
                                  gcat, cat, grid, 0, 1, True, [True, True]))
                    del cat, gcat, grid
                # the passes' split of the packed rows (the table's)
                parts = (pass_ms(kernel, A_BWD_FUNCS[1:])
                         if len(chans) > 1 and kind != "converge" else None)
                b, by = bound_ms(3 * nbytes(*ims) + 2 * nbytes(flow),
                                 22 * sum(im.numel() for im in ims),
                                 torch.float32)
                rows.append(dict(
                    name="warp_bwd", shape=label, dtype=dt, flow=kind,
                    max_abs_err=max(err_f, err_i),
                    err_dflow=err_f, tol_dflow=tol_f, err_dim=err_i,
                    tol_dim=tol_i, tol=max(tol_f, tol_i), **t,
                    dim_repeats=True,
                    bucket_ms=(sum(parts[f] for f in A_BWD_FUNCS[1:6])
                               if parts else None),
                    accumulate_ms=(sum(parts[f] for f in A_BWD_FUNCS[6:])
                                   if parts else None),
                    dflow_only_ms=graph_ms(lambda: tw.warp_backward_cuda(
                        ims, flow, gs, False)),
                    library="aten.grid_sampler_2d_backward(border, "
                            "align_corners=True)",
                    bound_ms=b, bound_by=by))
    return rows


# Kernel E' at the cascade step's bilinear resizes (batch 4 at 256x256):
# SpyNet's flow upsampling (bilinear_up2 of the 2-channel flow at each
# level's input size), the DMC's 0.5x motion resizes (bilinear_down2), and
# the perceptual loss's resize to 224: (label, N, C, H, W, output H, W).
RESIZE_BWD_SHAPES = (
    ("SpyNet up2 level 3", TN, 2, TH // 16, TW // 16, TH // 8, TW // 8),
    ("SpyNet up2 level 2", TN, 2, TH // 8, TW // 8, TH // 4, TW // 4),
    ("SpyNet up2 level 1", TN, 2, TH // 4, TW // 4, TH // 2, TW // 2),
    ("SpyNet up2 level 0", TN, 2, TH // 2, TW // 2, TH, TW),
    ("DMC down2 mv2", TN, 2, TH, TW, TH // 2, TW // 2),
    ("DMC down2 mv3", TN, 2, TH // 2, TW // 2, TH // 4, TW // 4),
    ("perceptual resize to 224", TN, 3, TH, TW, 224, 224),
)


def check_resize_bwd(g):
    """Kernel E' against resize_backward_plain (Ry^T . g . Rx, cuBLAS
    float64 products rounded once), f32 and bf16: within 1e-5 of the
    largest magnitude in f32 (E' sums in f32, in its own order), one bf16
    ulp in bf16; two calls give
    the same bits; beside aten's upsample_bilinear2d_backward (PyTorch's
    atomic backward of F.interpolate) and the bound (g read once, d x
    written once). Each row keeps a digest of d x's bytes (dx_sha256), so
    that this function run in another tree (a copy of this script there)
    shows whether that tree's E' gives the same bits."""
    from vcm_ts_tpu_torch.ops import resize as rs

    rows = []
    for name, n, c, h, w, ho, wo in RESIZE_BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            gr = torch.randn((n, c, ho, wo), device="cuda",
                             generator=g).to(dtype=dtype, memory_format=CL)
            got = rs.resize_backward_cuda(gr, h, w)
            want = rs.resize_backward_plain(gr, h, w)
            err = float((got.float() - want.float()).abs().max())
            tol = _bf16_or_f32_tol(want, dtype, 1e-5)
            dt = "f32" if dtype == torch.float32 else "bf16"
            label = f"{name} N={n} C={c} {ho}x{wo} -> {h}x{w} {dt}"
            if not err <= tol:
                raise AssertionError(f"resize_bwd {label}: err {err} (tol "
                                     f"{tol})")
            if not torch.equal(got, rs.resize_backward_cuda(gr, h, w)):
                raise AssertionError(f"resize_bwd {label}: two calls on the "
                                     "same inputs differ")
            t = times(lambda: rs.resize_backward_cuda(gr, h, w),
                      lambda: rs.resize_backward_plain(gr, h, w),
                      lambda: torch.ops.aten.upsample_bilinear2d_backward(
                          gr, [ho, wo], [n, c, h, w], False))
            b, by = bound_ms(nbytes(gr, got), 0, dtype)
            rows.append(dict(name="resize_bwd", shape=label, dtype=dt,
                             max_abs_err=err, tol=tol, **t,
                             library="aten.upsample_bilinear2d_backward",
                             bound_ms=b, bound_by=by,
                             dx_sha256=hashlib.sha256(
                                 got.permute(0, 2, 3, 1).contiguous().cpu()
                                 .view(torch.uint8).numpy().tobytes())
                             .hexdigest()))
    return rows


# The launch floor: an empty kernel, built beside the kernels with their
# nvcc flags. It is on no path of the port and replaces no TPU kernel.
LAUNCH_FLOOR_CU = r"""
__global__ void empty_kernel() {}

extern "C" int vcm_launch_floor(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def launch_floor_ms():
    """LAUNCH_FLOOR_CU's empty kernel replayed from a CUDA graph as
    graph_ms replays the kernels: one block of 32 threads, and 512 blocks
    of 256 (E''s largest grid at the step's shapes)."""
    import ctypes

    from vcm_ts_tpu_torch.ops import cuda_build

    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.BUILD_DIR, "launch_floor.cu")
    lib = os.path.join(cuda_build.BUILD_DIR, "liblaunch_floor.so")
    with open(src, "w") as f:
        f.write(LAUNCH_FLOOR_CU)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib,
                    src], check=True, capture_output=True, timeout=600)
    fn = ctypes.CDLL(lib).vcm_launch_floor
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def empty(blocks, threads):
        def run():
            cuda_build.check(fn(blocks, threads,
                                torch.cuda.current_stream().cuda_stream),
                             "launch_floor")
        return run

    return {"one_block_ms": graph_ms(empty(1, 32)),
            "grid_512x256_ms": graph_ms(empty(512, 256))}


def check_space_to_depth(g):
    """Kernel C' bit-identical to space_to_depth_plain at every subpel
    site; beside it F.pixel_unshuffle + the c-major -> k-major channel
    permutation; at the first kernel-B site also the cuBLAS products of
    B's backward (dx = gk w^T, dw = x^T gk, f32)."""
    from vcm_ts_tpu_torch.ops import subpel as ts

    rows = []
    for name, c, n, h, w in S2D_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            gr = torch.randn((n, c, h, w), device="cuda", generator=g).to(
                dtype=dtype, memory_format=CL)
            got = ts.space_to_depth_cuda(gr, 2)
            if not torch.equal(got, ts.space_to_depth_plain(gr, 2)):
                raise AssertionError(f"space_to_depth {name} C={c}: not "
                                     "bit-identical to the plain version")

            def library():
                u = F.pixel_unshuffle(gr, 2)
                return u.reshape(n, c, 4, h // 2, w // 2).transpose(
                    1, 2).reshape(n, 4 * c, h // 2, w // 2).contiguous(
                        memory_format=CL)

            if not torch.equal(library(), got):
                raise AssertionError("pixel_unshuffle + permutation != C'")
            t = times(lambda: ts.space_to_depth_cuda(gr, 2),
                      lambda: ts.space_to_depth_plain(gr, 2), library)
            b, by = bound_ms(2 * nbytes(gr), 0, dtype)
            dt = "f32" if dtype == torch.float32 else "bf16"
            row = dict(name="space_to_depth",
                       shape=f"{name} C={c} N={n} {h}x{w} {dt}", dtype=dt,
                       max_abs_err=0.0, tol=0.0, **t,
                       library="F.pixel_unshuffle + channel permutation",
                       bound_ms=b, bound_by=by)
            if name.startswith("UNet up2"):
                cin = 64
                gk2 = got.permute(0, 2, 3, 1).reshape(-1, 4 * c).float()
                x2 = torch.randn((gk2.shape[0], cin), device="cuda",
                                 generator=g)
                wt = torch.randn((4 * c, cin), device="cuda", generator=g)
                row["b_bwd_dx_ms"] = graph_ms(lambda: gk2 @ wt)
                row["b_bwd_dw_ms"] = graph_ms(lambda: x2.t() @ gk2)
            rows.append(row)
    return rows


def _train_stage(p_frames=2, perceptual=False):
    from vcm_ts_tpu_torch.train.stages import StageParams

    return StageParams(stage=0, p_frames=p_frames, trainable_mode="all",
                       forward_method="cascade", loss_dist_key="mse",
                       loss_rate_keys=("bpp_y", "bpp_z", "bpp_mv_y",
                                       "bpp_mv_z"), lr=1e-4,
                       perceptual_loss=perceptual)


LAMBDAS = [85.0, 170.0, 380.0, 840.0]


def _train_batch(h, w, p_frames=2, seed=0):
    """(p_frames + 1, 4, h, w, 3): four seeded moving sequences."""
    seqs = [moving_frames(p_frames + 1, h, w, seed=seed + i)
            for i in range(TN)]
    return torch.stack([torch.cat([s[t] for s in seqs])
                        for t in range(p_frames + 1)])


def train_reference(pl_kind=None):
    """One cascade step (p_frames 2, remat) of the seeded DMC at 64x64 on
    the CPU (plain versions) and on the card (kernels), the same noise
    (with pl_kind, the SOLVER.PL_MODEL perceptual loss, seeded, in it):
    FrameAux rtol 1e-3 (cuDNN's and the CPU's f32 convs sum in other
    orders, TF32 off); gradients (the first moments) within 2e-2 of each
    leaf's largest magnitude; parameters after AdamW within 1e-6 + 0.05 lr
    where |g| is above 4e-2 of its leaf's largest (there Adam's first step
    is a sign both sides share), within 2.1 lr elsewhere."""
    import copy

    from vcm_ts_tpu_torch.models.dmc import make_dpb
    from vcm_ts_tpu_torch.train import train_step as tts
    from vcm_ts_tpu_torch.train.optimizer import make_stage_optimizer
    from vcm_ts_tpu_torch.utils.weights import make_dmc

    lr = 1e-4
    model = make_dmc("cpu")
    seq = _train_batch(64, 64, seed=7)
    noises = tts.draw_cascade_noise(model, seq[1:],
                                    torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        opt = make_stage_optimizer(m, "all", lr)
        step = tts.make_cascade_step(
            m, opt, _train_stage(perceptual=pl_kind is not None),
            lambdas=LAMBDAS, dist_lambda=1.0,
            **({"pl_lambda": 0.0} if pl_kind is None
               else _pl_step_kwargs(pl_kind, dev)))
        xs = seq[1:].to(dev)
        aux, _ = step(xs, xs, make_dpb(seq[0].to(dev)),
                      [tuple(t.to(dev) for t in n) for n in noises])
        out[dev] = (aux, {k: v.cpu() for k, v in opt.mu.items()},
                    {k: p.detach().cpu() for k, p in m.named_parameters()})
    err = {}
    for f in tts.FrameAux._fields:
        a = getattr(out["cuda"][0], f).cpu()
        b = getattr(out["cpu"][0], f)
        err[f] = float(((a - b).abs() / b.abs().clamp_min(1e-6)).max())
        if not err[f] <= 1e-3:
            raise AssertionError(f"train step 64x64 card vs CPU: {f} "
                                 f"{a.tolist()} vs {b.tolist()}")
    g_err = p_err = 0.0
    for k, want in out["cpu"][1].items():
        scale = max(float(want.abs().max()), 1e-30)
        e = float((out["cuda"][1][k] - want).abs().max()) / scale
        g_err = max(g_err, e)
        if not e <= 2e-2:
            raise AssertionError(f"train step 64x64: gradient {k} off by "
                                 f"{e} of its scale")
        firm = want.abs() > 4e-2 * scale
        d = (out["cuda"][2][k] - out["cpu"][2][k]).abs()
        tol = torch.where(firm, torch.full_like(d, 1e-6 + 0.05 * lr),
                          torch.full_like(d, 2.1 * lr))
        if not bool((d <= tol).all()):
            raise AssertionError(f"train step 64x64: parameter {k} off by "
                                 f"{float(d.max())} after AdamW")
        p_err = max(p_err, float(d.max()))
    return {"aux_max_rel_err": err, "grad_max_rel_err": g_err,
            "param_max_abs_err": p_err,
            "loss_cpu": out["cpu"][0].loss.tolist(),
            "loss_cuda": out["cuda"][0].loss.tolist()}


def train_repeatable(seq):
    """Two cascade steps of the seeded DMC from the same state with the
    same noise, in f32 and with bf16 compute (--mp), without
    torch.use_deterministic_algorithms: {"f32" / "mp": the count and
    names of the parameter tensors that differ, "identical": none in
    either}; then, as a record, one f32 step under
    torch.use_deterministic_algorithms(True, warn_only=True): the ops that
    mode flags as having no deterministic CUDA path ("flagged")."""
    import copy
    import warnings

    from vcm_ts_tpu_torch.models.dmc import make_dpb
    from vcm_ts_tpu_torch.train import train_step as tts
    from vcm_ts_tpu_torch.train.optimizer import make_stage_optimizer
    from vcm_ts_tpu_torch.utils.weights import make_dmc

    base = make_dmc("cuda")
    noises = tts.draw_cascade_noise(
        base, seq[1:], torch.Generator(device="cuda").manual_seed(3))

    def one_step(compute_dtype):
        m = copy.deepcopy(base)
        opt = make_stage_optimizer(m, "all", 1e-4)
        step = tts.make_cascade_step(m, opt, _train_stage(),
                                     lambdas=LAMBDAS, dist_lambda=1.0,
                                     pl_lambda=0.0,
                                     compute_dtype=compute_dtype)
        step(seq[1:], seq[1:], make_dpb(seq[0]), noises)
        torch.cuda.synchronize()
        return {k: p.detach().clone() for k, p in m.named_parameters()}

    out = {"params": sum(1 for _ in base.parameters())}
    for label, dt in (("f32", None), ("mp", torch.bfloat16)):
        a, b = one_step(dt), one_step(dt)
        out[label] = [k for k in a if not torch.equal(a[k], b[k])]
    out["identical"] = not (out["f32"] or out["mp"])
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            one_step(None)
    finally:
        torch.use_deterministic_algorithms(False)
    out["flagged"] = sorted({str(w.message).split(" does not have a "
                                                  "deterministic")[0]
                             for w in caught
                             if "deterministic" in str(w.message)})
    return out


def run_train_bench(label, argv):
    """The port bench's --train-step; every kernel of the training path
    launched (A, A', B, C, C'; not D)."""
    res = run_bench(label, argv)
    missing = [k for k in TRAIN_KERNELS if not res["launches"][k] > 0]
    if missing:
        raise AssertionError(f"train bench {label}: {missing} not launched, "
                             f"launches {res['launches']}")
    return res


def run_train(smi):
    """Phase 8 after the kernel rows: the 64x64 reference, the bench, one
    profiled cascade step with its launches, the 20-step gate."""
    from vcm_ts_tpu_torch.models.dmc import make_dpb
    from vcm_ts_tpu_torch.ops import cuda_build
    from vcm_ts_tpu_torch.train import train_step as tts
    from vcm_ts_tpu_torch.train.optimizer import make_stage_optimizer
    from vcm_ts_tpu_torch.utils.weights import make_dmc

    out = {}
    t = time.perf_counter()
    out["reference"] = train_reference()
    say(f"[train] 64x64 cascade step card vs CPU: {out['reference']} "
        f"({time.perf_counter() - t:.1f} s)")

    common = ["--train-step", "--frames", "16", "--warmup", "2"]
    out["bench"] = []
    for label, extra in (("f32", []), ("mp", ["--mp"]),
                         ("f32 grad-accum 2", ["--grad-accum", "2"])):
        b = run_train_bench(label, common + extra)
        out["bench"].append(b)
        say(f"[train bench] {label}: {b['value']} frames/s, step "
            f"{b['step_ms']:.1f} ms, peak {b['peak_mem_gib']} GiB, loss "
            f"{[round(v, 3) for v in b['loss']]}, launches {b['launches']} "
            f"({b['held_s']:.1f} s; {smi})")

    model = make_dmc("cuda")
    opt = make_stage_optimizer(model, "all", 1e-4)
    step = tts.make_cascade_step(model, opt, _train_stage(),
                                 lambdas=LAMBDAS, dist_lambda=1.0,
                                 pl_lambda=0.0)
    seq = _train_batch(TH, TW).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def one():
        noises = tts.draw_cascade_noise(model, seq[1:], gen)
        return step(seq[1:], seq[1:], make_dpb(seq[0]), noises)[0]

    one()
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    one()
    torch.cuda.synchronize()
    out["launches"] = dict(cuda_build.LAUNCHES)
    for k in TRAIN_KERNELS:
        if not out["launches"][k] > 0:
            raise AssertionError(f"cascade step: {k} not launched: "
                                 f"{out['launches']}")
    say(f"[train] one cascade step (p_frames 2, remat, 4x{TH}x{TW} f32) "
        f"launches {out['launches']}")
    out["profile"] = profile_ms(one)
    p = out["profile"]
    top = ", ".join(f"{k['name'][:50]} {k['ms']:.1f} ms x{k['launches']}"
                    for k in p["top_kernels"][:6])
    say(f"[train profile] cascade step: wall {p['wall_ms']:.1f} ms, device "
        f"busy {p['device_busy_ms']:.1f} ms, idle share "
        f"{p['idle_share']:.3f}, {p['launches']} launches; top: {top} "
        f"({smi})")
    ours = ", ".join(f"{k} {v['ms']:.3f} ms x{v['launches']}"
                     for k, v in p["port_kernels"].items())
    say(f"[train profile] port kernels: {ours}")
    pk = p["port_kernels"]
    out["a_bwd_ms"] = sum(pk.get(f, {"ms": 0.0})["ms"] for f in A_BWD_FUNCS)
    out["e_bwd_ms"] = sum(pk.get(f, {"ms": 0.0})["ms"] for f in E_BWD_FUNCS)
    share = (out["a_bwd_ms"] + out["e_bwd_ms"]) / p["device_busy_ms"]
    out["ae_bwd_share"] = share
    say(f"[train profile] kernel A' {out['a_bwd_ms']:.3f} ms "
        f"({out['a_bwd_ms'] / p['device_busy_ms']:.5f} of the device-busy "
        f"time) and E' {out['e_bwd_ms']:.3f} ms "
        f"({out['e_bwd_ms'] / p['device_busy_ms']:.5f}) of the cascade "
        f"step's {p['device_busy_ms']:.1f} ms ({smi})")
    if not share < 0.01:
        raise AssertionError(f"cascade step: A' and E' take {share:.4f} of "
                             "the device-busy time (limit 0.01)")
    out["repeatable"] = train_repeatable(seq)
    r = out["repeatable"]
    say(f"[train] two cascade steps from one state (4x{TH}x{TW}, the same "
        f"noise, no deterministic mode): parameters bit-identical in f32 "
        f"({len(r['f32'])} of {r['params']} tensors differ) and with bf16 "
        f"compute, --mp ({len(r['mp'])} differ): {r['identical']}; ops "
        f"torch.use_deterministic_algorithms flags in the f32 step: "
        f"{r['flagged'] or 'none'}")
    if not r["identical"]:
        raise AssertionError(f"two cascade steps from one state differ: f32 "
                             f"{r['f32'][:5]}, mp {r['mp'][:5]}")

    losses = []
    for _ in range(20):
        losses.append(float(one().loss.mean()))
    out["gate_losses"] = losses
    if not (all(np.isfinite(losses))
            and np.mean(losses[-3:]) < np.mean(losses[:3])):
        raise AssertionError(f"the loss did not fall over 20 steps: {losses}")
    say(f"[train gate] loss over 20 cascade steps on a fixed 4x{TH}x{TW} "
        f"batch: {losses[0]:.4f} -> {losses[-1]:.4f} (first 3 mean "
        f"{np.mean(losses[:3]):.4f}, last 3 {np.mean(losses[-3:]):.4f})")
    return out


# ------------------------------------------------------------------ phase 9
EVAL_FRAMES, EVAL_GOP, EVAL_RATES = 5, 4, 4


def _u8(frame):
    """(1, H, W, 3) float [0, 1] tensor -> (H, W, 3) uint8."""
    return (frame[0] * 255).round().clamp(0, 255).to(torch.uint8).numpy()


def _frame_keys(log):
    return {k: log[k] for k in ("frame_type", "frame_bpp", "frame_psnr",
                                "frame_msssim")}


def _harness(argv, timers=None):
    """One run of vcm_ts_tpu_torch.test_video.main: (log, seconds)."""
    from vcm_ts_tpu_torch import test_video

    torch.cuda.synchronize()
    t = time.perf_counter()
    log = test_video.main(argv, timers=timers)
    torch.cuda.synchronize()
    return log, time.perf_counter() - t


def run_eval(out_dir, smi):
    """Phase 9: the codec eval harness at 1088x1920 (test_video.main: real
    streams one rate point after another, the same batched over the rate
    points, entropy-estimated), the decoding sweep's DCVC branch, BD
    metrics and benchmark_plot's PSNR / MS-SSIM, with their gates."""
    from vcm_ts_tpu_torch import bd_rate as bdr
    from vcm_ts_tpu_torch import benchmark_plot as bp
    from vcm_ts_tpu_torch import benchmark_videos_decoding as bvd
    from vcm_ts_tpu_torch import test_video
    from vcm_ts_tpu_torch.codec.png_io import PNGReader, write_png
    from vcm_ts_tpu_torch.eval.bd_metrics import bd_psnr, bd_rate
    from vcm_ts_tpu_torch.ops import cuda_build
    from vcm_ts_tpu_torch.utils.weights import make_dmc, make_intra

    t_phase = time.perf_counter()
    j = os.path.join
    root = j(out_dir, "eval")
    shutil.rmtree(root, ignore_errors=True)
    images = j(root, "data", "seq1088", "images")
    os.makedirs(images)
    for i, f in enumerate(moving_frames(EVAL_FRAMES, H, W, seed=9)):
        write_png(j(images, f"im{i + 1:05d}.png"), _u8(f))
    ckpt = {"i": j(root, "intra.pth"), "p": j(root, "dmc.pth")}
    save_codec_pth(make_intra("cpu"), ckpt["i"])
    save_codec_pth(make_dmc("cpu"), ckpt["p"])
    with open(j(root, "test.json"), "w") as f:
        json.dump({"root_path": j(root, "data"), "test_classes": {
            "smoke": {"test": 1, "base_path": "seq1088", "sequences": {
                "images": {"gop": EVAL_GOP, "frames": EVAL_FRAMES}}}}}, f)

    def argv(name, *extra):
        return ["--test_config", j(root, "test.json"), "--i_frame_model_path",
                ckpt["i"], "--model_path", ckpt["p"], "--rate_num",
                str(EVAL_RATES), "--output_path", j(root, f"{name}.json"),
                "--stream_path", j(root, f"{name}_bin"), *extra]

    out = {"frames": EVAL_FRAMES, "gop": EVAL_GOP, "rates": EVAL_RATES}
    timers: dict = {}
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    seq, out["seq_s"] = _harness(argv("seq", "--write_stream", "1"), timers)
    out["launches"] = dict(cuda_build.LAUNCHES)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    missing = [k for k in ("warp", "subpel_conv1x1", "pixel_shuffle_relayout")
               if not out["launches"][k] > 0]
    if missing:
        raise AssertionError(f"eval harness: {missing} not launched: "
                             f"{out['launches']}")
    seq = seq["smoke"]["images"]
    bat, out["batched_s"] = _harness(argv("bat", "--write_stream", "1",
                                          "--batch_rates", "1"))
    bat = bat["smoke"]["images"]
    est, out["estimated_s"] = _harness(argv("est"))
    est = est["smoke"]["images"]

    # gates: the batched run equals the sequential one, .bin for .bin
    n_bins = 0
    for r in range(EVAL_RATES):
        k = f"{r:03d}"
        if _frame_keys(bat[k]) != _frame_keys(seq[k]):
            raise AssertionError(f"eval: batched log rate {r} differs: "
                                 f"{_frame_keys(bat[k])} vs "
                                 f"{_frame_keys(seq[k])}")
        for fi in range(EVAL_FRAMES):
            a, b = (open(j(root, f"{m}_bin", "images", str(r), f"{fi}.bin"),
                         "rb").read() for m in ("seq", "bat"))
            if a != b:
                raise AssertionError(f"eval: rate {r} frame {fi}: batched "
                                     ".bin differs from the sequential one")
            n_bins += 1
    out["bins_equal"] = n_bins
    out["rate_points"] = []
    for r in range(EVAL_RATES):
        log = seq[f"{r:03d}"]
        rep = timers[("smoke", "images", r)].report()
        out["rate_points"].append({
            "wall_s": log["decoded"], "i_frame_ms": rep["i_frame"]["mean_ms"],
            "p_frame_ms": rep["p_frame"]["mean_ms"],
            "bpp": log["ave_all_frame_bpp"], "psnr": log["ave_all_frame_psnr"],
            "msssim": log["ave_all_frame_msssim"],
            "estimated_bpp": est[f"{r:03d}"]["ave_all_frame_bpp"]})

    # one rate point under the profiler (real streams)
    task = {"frame_num": EVAL_FRAMES, "gop_size": EVAL_GOP,
            "img_path": images, "write_stream": True,
            "bin_folder": j(root, "profile_bin"),
            "i_frame_q_scale": Q_ANCHORS[0], "p_frame_y_q_scale": Q_ANCHORS[0],
            "p_frame_mv_y_q_scale": Q_ANCHORS[0]}
    os.makedirs(task["bin_folder"])
    ic, vc = test_video.build_codecs(test_video.parse_args(
        argv("prof", "--write_stream", "1")))
    out["profile"] = profile_ms(lambda: test_video.run_test(vc, ic, task))
    del ic, vc

    # the decoding sweep (DCVC branch), gop 4, 4 rates
    sweep_cfg = {"dataset_dir": j(root, "data"), "gop": EVAL_GOP,
                 "rate_count": EVAL_RATES, "out_dir": j(root, "decoded"),
                 "codecs": {"DCVC-HEM": [{
                     "name": "DCVC-HEM", "anchor_num": 4,
                     "image_model_weights": ckpt["i"],
                     "video_model_weights": ckpt["p"]}]}}
    with open(j(root, "sweep.json"), "w") as f:
        json.dump(sweep_cfg, f)
    t = time.perf_counter()
    bvd.main(["--config", j(root, "sweep.json")])
    out["sweep_s"] = time.perf_counter() - t
    for r in range(EVAL_RATES):
        with open(j(root, "decoded", "DCVC-HEM", "seq1088",
                    f"quality_{r}.json")) as f:
            sw = json.load(f)
        want = est[f"{r:03d}"]["frame_bpp"]
        if sw["frame_bpp"] != want:
            raise AssertionError(f"eval: sweep bits rate {r} "
                                 f"{sw['frame_bpp']} != harness {want}")

    # benchmark_plot's metrics over the sweep's output (no detector)
    reader = PNGReader(images)
    dataset = {"seq1088": {
        "images": [reader.read_one_frame() for _ in range(EVAL_FRAMES)],
        "annotations": {}, "classes": [], "class_names": [], "mean_ap": 0}}
    t = time.perf_counter()
    metrics = bp.get_metrics(j(root, "decoded"), {}, None, dataset, True, 1)
    out["metrics_s"] = time.perf_counter() - t
    sweep_curve = metrics["DCVC-HEM"]["seq1088"]
    out["sweep_curve"] = [{k: e[k] for k in ("bpp", "psnr", "ssim")}
                          for e in sweep_curve]

    # BD metrics: the sweep's curve against the harness's, and a curve
    # against itself (0)
    harness_curve = [{"bpp": seq[f"{r:03d}"]["ave_all_frame_bpp"],
                      "psnr": seq[f"{r:03d}"]["ave_all_frame_psnr"],
                      "mean_ap": {}} for r in range(EVAL_RATES)]
    curves = {"harness": {"seq1088": harness_curve},
              "sweep": {"seq1088": sweep_curve},
              "sweep copy": {"seq1088": sweep_curve}}
    bdr.compute_bd(curves, "sweep", "pchip", root)
    with open(j(root, "bd_metrics.txt")) as f:
        out["bd_text"] = f.read()
    rate = [e["bpp"] for e in sweep_curve]
    psnr = [e["psnr"] for e in sweep_curve]
    out["bd_self"] = (bd_rate(rate, psnr, rate, psnr),
                      bd_psnr(rate, psnr, rate, psnr))
    if not all(abs(v) <= 1e-6 for v in out["bd_self"]):
        raise AssertionError(f"eval: BD of a curve against itself "
                             f"{out['bd_self']}")
    # phase 12 reruns two rate points over these frames in two ranks and
    # deletes the tree (about 150 MB of frames and streams)
    out["root"] = root
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def say_eval(v, smi):
    tag = f"[eval] {v['frames']} frames {W}x{H} gop {v['gop']}"
    for r, p in enumerate(v["rate_points"]):
        say(f"{tag} rate {r}: wall {p['wall_s']:.3f} s, I-frame "
            f"{p['i_frame_ms']:.1f} ms, P-frame {p['p_frame_ms']:.1f} ms "
            f"(coded, decoded and measured), bpp {p['bpp']:.6f} (estimated "
            f"{p['estimated_bpp']:.6f}), PSNR {p['psnr']:.4f} dB, MS-SSIM "
            f"{p['msssim']:.6f} ({smi})")
    p = v["profile"]
    say(f"{tag} one rate point (write_stream) profiled: wall "
        f"{p['wall_ms']:.1f} ms, device busy {p['device_busy_ms']:.1f} ms, "
        f"device-busy share {1 - p['idle_share']:.3f}, {p['launches']} "
        f"launches; top: " + ", ".join(
            f"{k['name'][:60]} {k['ms']:.1f} ms x{k['launches']}"
            for k in p["top_kernels"][:4]) + f" ({smi})")
    say(f"{tag} runs: sequential write_stream {v['seq_s']:.1f} s (launches "
        f"{v['launches']}, peak {v['peak_bytes'] / 2**30:.2f} GiB), batched "
        f"{v['batched_s']:.1f} s, estimated {v['estimated_s']:.1f} s, sweep "
        f"{v['sweep_s']:.1f} s, plot metrics {v['metrics_s']:.1f} s; "
        f"{v['bins_equal']} batched .bin == sequential; sweep bits == "
        f"harness (estimated) at every rate; BD self {v['bd_self']} "
        f"(phase {v['phase_s']:.1f} s; {smi})")
    say(f"{tag} sweep curve {v['sweep_curve']}; bd_metrics.txt: "
        + " | ".join(line.strip() for line in v["bd_text"].splitlines()))


# ----------------------------------------------------------------- phase 10
LOOP_TRAIN, LOOP_TEST, LOOP_T = 8, 4, 6  # sequences, sequences, frames
RESUMES = 2
LOOP_STAGES = [["1", "me", "single", "me", "none", "0.0001", "1", "false"],
               ["1", "rec", "single", "rec", "rec", "0.0001", "1", "false"],
               ["2", "all", "cascade", "rec", "all", "0.0001", "2", "false"]]


def _trainer(argv):
    """One in-process run of python -m vcm_ts_tpu_torch.trainer: (its
    record, seconds)."""
    from vcm_ts_tpu_torch import trainer

    torch.cuda.synchronize()
    t = time.perf_counter()
    rec = trainer.main(argv)
    torch.cuda.synchronize()
    return rec, time.perf_counter() - t


def _rel_diffs(got, want):
    """Per iteration, the largest relative difference over the anchors."""
    return [float(np.max(np.abs(np.subtract(g, w))
                         / np.maximum(np.abs(w), 1e-12)))
            for g, w in zip(got, want)]


def _resume_fresh_moments(cfg_path, root):
    """The resume of run_trainloop from model_epoch_002.pt, through
    do_train with the optimizer's moments left fresh: its record."""
    from vcm_ts_tpu_torch.data import make_data_loader
    from vcm_ts_tpu_torch.models.dmc import DMC
    from vcm_ts_tpu_torch.train.checkpoint import CheckPointer
    from vcm_ts_tpu_torch.train.tensorboard import MetricWriter
    from vcm_ts_tpu_torch.train.train_loop import do_train
    from vcm_ts_tpu_torch.utils.config import default_training_cfg

    cfg = default_training_cfg()
    cfg.merge_from_file(cfg_path)
    cfg.OUTPUT_DIR = os.path.join(root, "fresh_moments")
    cfg.freeze()
    model = DMC(device="cuda")
    extra = CheckPointer().load(
        model, path=os.path.join(root, "run", "model_epoch_002.pt"))
    return do_train(cfg, model, make_data_loader(cfg, 0), None,
                    start_epoch=int(extra["epoch"]), seed=0,
                    writer=MetricWriter(cfg.OUTPUT_DIR, enable_tb=False))


def write_loop_tree(root, stages):
    """A fresh PNG tree of LOOP_TRAIN train and LOOP_TEST test sequences of
    LOOP_T 256x256 tiles under `root`, the seeded damped DMC as a .pth and
    the trainer's YAML for `stages` (published widths, 4 anchors, remat);
    returns the YAML's path."""
    from vcm_ts_tpu_torch.codec.png_io import write_png
    from vcm_ts_tpu_torch.utils.weights import make_dmc

    j = os.path.join
    shutil.rmtree(root, ignore_errors=True)
    for split, n, seed in (("train", LOOP_TRAIN, 20), ("test", LOOP_TEST, 40)):
        for s in range(n):
            d = j(root, split, "set", f"seq{s}", "raw")
            os.makedirs(d)
            for t, f in enumerate(moving_frames(LOOP_T, TH, TW,
                                                seed=seed + s)):
                write_png(j(d, f"{t:05d}.png"), _u8(f))
    dmc_pth = j(root, "dmc.pth")
    save_codec_pth(make_dmc("cpu"), dmc_pth)
    lines = "\n".join(f"    - {json.dumps(s)}" for s in stages)
    cfg = j(root, "cfg.yaml")
    with open(cfg, "w") as f:
        f.write(f"""MODEL:
  PRETRAINED_WEIGHTS: '{dmc_pth}'
  CHANNELS: [64, 64, 96]
DATASET:
  TYPE: SequenceDataset
  TRAIN_ROOT_DIRS: ['{j(root, "train")}']
  TRAIN_SUBDIR_LISTS: ['']
  TEST_ROOT_DIRS: ['{j(root, "test")}']
  TEST_SUBDIR_LISTS: ['']
  SEQUENCE_LENGTH: {LOOP_T}
INPUT:
  IMAGE_SIZE: [{TW}, {TH}]
SOLVER:
  LAMBDAS: [85, 170, 380, 840]
  CASCADE_REMAT: true
  STAGES:
{lines}
OUTPUT_DIR: '{j(root, "run")}'
""")
    return cfg


def run_trainloop(out_dir, smi):
    """Phase 10: the trainer CLI over a PNG tree of 256x256 tiles with the
    published widths (3 stages, 4 epochs, eval and a checkpoint after each),
    then a resume from the cascade stage's first checkpoint, with gates."""
    from vcm_ts_tpu_torch.models.dmc import DMC
    from vcm_ts_tpu_torch.ops import cuda_build

    t_phase = time.perf_counter()
    j = os.path.join
    root = j(out_dir, "trainloop")
    cfg = write_loop_tree(root, LOOP_STAGES)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    rec, out["run_s"] = _trainer(["--config-file", cfg])
    out["launches"] = dict(cuda_build.LAUNCHES)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    missing = [k for k in TRAIN_KERNELS if not out["launches"][k] > 0]
    if missing:
        raise AssertionError(f"train loop: {missing} not launched: "
                             f"{out['launches']}")
    epochs = rec["epochs"]
    out["epochs"] = epochs
    entered = [e["stage"] for e in epochs]
    if entered != [0, 1, 2, 2]:
        raise AssertionError(f"train loop: stages {entered}")
    losses = [v for it in rec["iterations"] for v in it["loss"]]
    if not (losses and np.all(np.isfinite(losses))):
        raise AssertionError(f"train loop: a loss is not finite: {losses}")
    if not all(e.get("eval") and np.all(np.isfinite(e["eval"]["loss"]))
               for e in epochs):
        raise AssertionError("train loop: eval metrics missing for an epoch")
    with open(j(root, "run", "metrics.jsonl")) as f:
        eval_steps = {json.loads(line)["step"] for line in f
                      if json.loads(line)["tag"] == "eval/loss/lambda_85.0"}
    if len(eval_steps) != len(epochs):
        raise AssertionError(f"train loop: eval metrics written at steps "
                             f"{sorted(eval_steps)} for {len(epochs)} epochs")
    for e in range(len(epochs)):
        path = j(root, "run", f"model_epoch_{e:03d}.pt")
        m = DMC(device="cpu")
        m.load_state_dict(torch.load(path, weights_only=True)["params"],
                          strict=True)
    out["checkpoints"] = len(epochs)

    # resume from the cascade stage's first epoch (mid-stage: the moments
    # are restored) RESUMES times from the same checkpoint, and, as a
    # control, once with fresh moments. The card's steps repeat bit for
    # bit (kernels A' and E' sum in fixed orders), and the noise is keyed
    # by (seed, epoch), so every resume's losses equal the uninterrupted
    # run's at every iteration, as on the CPU; the control must differ.
    def resumed(name):
        d = j(root, name)
        os.makedirs(d)
        shutil.copy(j(root, "run", "model_epoch_002.pt"), d)
        with open(j(d, "last_checkpoint.txt"), "w") as f:
            f.write(j(d, "model_epoch_002.pt"))
        rec_r, sec = _trainer(["--config-file", cfg, "OUTPUT_DIR", d])
        return [it["loss"] for it in rec_r["iterations"]], sec

    want = [it["loss"] for it in rec["iterations"] if it["epoch"] == 3]
    runs = [resumed(f"resume{k}") for k in range(RESUMES)]
    out["resume_s"] = runs[0][1]
    if not want or any(len(r) != len(want) for r, _ in runs):
        raise AssertionError(f"train loop resume: {[len(r) for r, _ in runs]}"
                             f" iterations, want {len(want)}")
    out["resume_rel_diff"] = [_rel_diffs(r, want) for r, _ in runs]
    out["fresh_moments_rel_diff"] = _rel_diffs(
        [it["loss"] for it in _resume_fresh_moments(cfg, root)["iterations"]],
        want)
    for k, (r, _) in enumerate(runs):
        if r != want:
            gaps = _g3(out["resume_rel_diff"][k])
            raise AssertionError(
                f"train loop resume {k}: losses differ from the "
                f"uninterrupted run's (relative {gaps} by iteration)")
    if not max(out["fresh_moments_rel_diff"]) > 0:
        raise AssertionError("train loop resume: fresh moments gave the "
                             "uninterrupted run's losses")

    # the first cascade epoch pays the cascade step's warm-up
    cascade = [e for e in epochs if e["stage"] == 2]
    out["cascade_frames_per_s"] = (sum(e["frames"] for e in cascade[1:])
                                   / sum(e["train_s"] for e in cascade[1:]))
    out["cascade_first_frames_per_s"] = (cascade[0]["frames"]
                                         / cascade[0]["train_s"])
    out["loader_wait_share"] = (sum(e["loader_wait_s"] for e in epochs)
                                / sum(e["train_s"] for e in epochs))
    out["eval_s"] = sum(e["eval_s"] for e in epochs)
    out["checkpoint_s"] = sum(e["checkpoint_s"] for e in epochs)
    shutil.rmtree(root)  # tiles and checkpoints, about 200 MB
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def say_trainloop(v, bench_fps, smi):
    tag = (f"[trainloop] {LOOP_TRAIN} train / {LOOP_TEST} test sequences of "
           f"{LOOP_T} {TW}x{TH} tiles, 4 anchors, stages "
           + " ".join("/".join(s[:3]) + f" x{s[6]}" for s in LOOP_STAGES))
    say(f"{tag}: per epoch " + "; ".join(
        f"epoch {e['epoch']} stage {e['stage']}: {e['frames']} frames in "
        f"{e['train_s']:.2f} s (loader wait {e['loader_wait_s']:.3f} s), "
        f"eval {e['eval_s']:.2f} s, checkpoint {e['checkpoint_s']:.2f} s, "
        f"eval loss {[round(x, 3) for x in e['eval']['loss']]}"
        for e in v["epochs"]) + f" ({smi})")
    say(f"{tag}: cascade stage after its first epoch "
        f"{v['cascade_frames_per_s']:.3f} frames/s (its first epoch "
        f"{v['cascade_first_frames_per_s']:.3f}; eval {v['eval_s']:.2f} s "
        f"and checkpoints {v['checkpoint_s']:.2f} s apart; the bench's "
        f"--train-step f32 in this run {bench_fps} frames/s), loader wait "
        f"share {v['loader_wait_share']:.4f}, peak "
        f"{v['peak_bytes'] / 2**30:.2f} GiB, launches {v['launches']}; "
        f"{v['checkpoints']} checkpoints load strict; {RESUMES} resumes from "
        f"epoch 2's checkpoint: epoch 3's losses equal the uninterrupted "
        f"run's bit for bit at every iteration; with fresh moments instead "
        f"{_g3(v['fresh_moments_rel_diff'])} relative; run "
        f"{v['run_s']:.1f} s, resume "
        f"{v['resume_s']:.1f} s (phase {v['phase_s']:.1f} s; {smi})")


# ----------------------------------------------------------------- phase 11
PL_KINDS = ("resnet", "fpn", "yolo")
PL_STAGES = [["2", "all", "cascade", "rec", "all", "0.0001", "2", "true"]]
PL_GATE_STEPS = 20
RCNN_SCORE_GAIN = 8.0  # the seeded detector's class-score weights, scaled


def _pl_step_kwargs(kind, device):
    """make_cascade_step's perceptual arguments: the seeded SOLVER.PL_MODEL
    loss (no weights file ships) and the default PL_LAMBDA."""
    from vcm_ts_tpu_torch.train.losses import get_perceptual_loss
    from vcm_ts_tpu_torch.utils.config import default_training_cfg

    cfg = default_training_cfg()
    cfg.SOLVER.PL_MODEL = kind
    return {"pl_fn": get_perceptual_loss(cfg, device, seed=0),
            "pl_lambda": float(cfg.SOLVER.PL_LAMBDA)}


def _pl_frames(n, h, w, seed=11):
    """(decoded, target) NHWC f32: a seeded moving frame and a noisy copy
    with values at and past the clip's bounds."""
    target = torch.cat(moving_frames(n, h, w, seed=seed))
    g = torch.Generator().manual_seed(seed + 1)
    decoded = target + 0.05 * torch.randn(target.shape, generator=g)
    decoded[:, ::7, ::5] = 0.0
    return decoded, target


def _pl_call(kind, model, target, decoded, layers):
    """pl_fn's call on a given copy of its network (f32 or float64)."""
    t = target.permute(0, 3, 1, 2).contiguous()
    d = decoded.permute(0, 3, 1, 2).contiguous()
    if kind == "yolo":
        return model(t, d, feature_layers=layers)
    return model(d, t, feature_layers=layers)


def check_perceptual_losses(smi):
    """Phase 11 (a): each loss (seeded, f32, default PL_LAYERS) on the card
    against the CPU at the train step's shape (4x256x256) and at 1088x1920,
    both resized to 224 (the YOLO loss pads to /32 instead): the value
    rtol 1e-4; d decoded in float64 on both devices within 1e-3 of the
    largest (not the YOLO loss at 1088x1920: YOLOv8m's float64 backward
    there is minutes of CPU) and the card's f32 d decoded within 2e-2 of
    its float64 one in the 2-norm (an f32 ReLU or max-pool input within
    rounding of a kink takes the other branch now and then); the card's
    ms per call, forward and forward + backward, inside
    rowwise.whole_batch() as the train step calls it."""
    from vcm_ts_tpu_torch.ops import rowwise
    from vcm_ts_tpu_torch.train.losses import get_perceptual_loss
    from vcm_ts_tpu_torch.utils.config import default_training_cfg

    f32, f64 = torch.float32, torch.float64
    rows = []
    for kind in PL_KINDS:
        cfg = default_training_cfg()
        cfg.SOLVER.PL_MODEL = kind
        layers = tuple(cfg.SOLVER.PL_LAYERS)
        pls = {dev: get_perceptual_loss(cfg, dev, seed=0)
               for dev in ("cpu", "cuda")}
        nets64 = {dev: copy.deepcopy(pls[dev].model).double()
                  for dev in ("cpu", "cuda")}
        for n, h, w in ((TN, TH, TW), (1, H, W)):
            decoded, target = _pl_frames(n, h, w)
            cpu64 = kind != "yolo" or h == TH
            r = {"loss": kind, "shape": [n, h, w], "layers": list(layers)}
            with torch.no_grad():
                v_cpu = _pl_call(kind, pls["cpu"].model, target, decoded,
                                 layers)
            grads = {}
            for dev, dt in (("cuda", f32), ("cuda", f64)) + (
                    (("cpu", f64),) if cpu64 else ()):
                model = pls[dev].model if dt == f32 else nets64[dev]
                d = decoded.to(dev, dt).detach().clone().requires_grad_()
                with rowwise.whole_batch():
                    v = _pl_call(kind, model, target.to(dev, dt), d, layers)
                v.sum().backward()
                grads[dev, dt] = d.grad.double().cpu()
                if (dev, dt) == ("cuda", f32):
                    v_card = v.detach().cpu()
            r["value_cpu"], r["value_cuda"] = v_cpu.tolist(), v_card.tolist()
            r["value_rel_err"] = float(((v_card - v_cpu).abs()
                                        / v_cpu.abs()).max())
            g64 = grads["cuda", f64]
            r["grad_f32_vs_f64_norm_rel"] = float(
                (grads["cuda", f32] - g64).norm() / g64.norm())
            r["grad_f32_vs_f64_max_rel"] = float(
                (grads["cuda", f32] - g64).abs().max() / g64.abs().max())
            r["grad_f64_card_vs_cpu_max_rel"] = None
            if cpu64:
                want = grads["cpu", f64]
                r["grad_f64_card_vs_cpu_max_rel"] = float(
                    (g64 - want).abs().max() / want.abs().max())
            if not (r["value_rel_err"] <= 1e-4
                    and r["grad_f32_vs_f64_norm_rel"] <= 2e-2
                    and (r["grad_f64_card_vs_cpu_max_rel"] is None
                         or r["grad_f64_card_vs_cpu_max_rel"] <= 1e-3)
                    and float(g64.abs().max()) > 0):
                raise AssertionError(f"perceptual loss card vs CPU: {r}")

            pl = pls["cuda"]
            dc, tc = decoded.cuda(), target.cuda()
            dg = dc.clone().requires_grad_()

            def fwd():
                with torch.no_grad(), rowwise.whole_batch():
                    pl(tc, dc)

            def fwd_bwd():
                with rowwise.whole_batch():
                    pl(tc, dg).sum().backward()

            r["fwd_ms"] = cuda_ms(fwd, iters=5)
            r["fwd_bwd_ms"] = cuda_ms(fwd_bwd, iters=5)
            rows.append(r)
            err64 = r["grad_f64_card_vs_cpu_max_rel"]
            say(f"[perceptual] {kind} {n}x{h}x{w}: value card "
                f"{_g3(r['value_cuda'])} vs CPU rel err "
                f"{r['value_rel_err']:.3g}; d decoded float64 card vs CPU "
                + ("not run" if err64 is None else f"{err64:.3g}")
                + " of the largest; card f32 vs float64 "
                f"{r['grad_f32_vs_f64_norm_rel']:.3g} (2-norm), "
                f"{r['grad_f32_vs_f64_max_rel']:.3g} (largest element); "
                f"card ms per call forward {r['fwd_ms']:.3f}, forward + "
                f"backward {r['fwd_bwd_ms']:.3f} ({smi})")
    return rows


def run_perceptual_step(smi):
    """Phase 11 (b): the cascade step of phase 8 (p_frames 2, remat, 4
    anchors, 4x256x256, f32) with the ResNet loss: the 64x64 step card
    against the CPU (phase 8's gate), launches and peak memory of one
    warm step, a profiled step, and the loss falling over
    PL_GATE_STEPS steps."""
    from vcm_ts_tpu_torch.models.dmc import make_dpb
    from vcm_ts_tpu_torch.ops import cuda_build
    from vcm_ts_tpu_torch.train import train_step as tts
    from vcm_ts_tpu_torch.train.optimizer import make_stage_optimizer
    from vcm_ts_tpu_torch.utils.weights import make_dmc

    out = {}
    t = time.perf_counter()
    out["reference"] = train_reference("resnet")
    say(f"[perceptual step] 64x64 cascade step with the ResNet loss, card vs "
        f"CPU: {out['reference']} ({time.perf_counter() - t:.1f} s)")
    model = make_dmc("cuda")
    opt = make_stage_optimizer(model, "all", 1e-4)
    pl_kwargs = _pl_step_kwargs("resnet", "cuda")
    step = tts.make_cascade_step(model, opt, _train_stage(perceptual=True),
                                 lambdas=LAMBDAS, dist_lambda=1.0,
                                 **pl_kwargs)
    seq = _train_batch(TH, TW).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def one():
        noises = tts.draw_cascade_noise(model, seq[1:], gen)
        return step(seq[1:], seq[1:], make_dpb(seq[0]), noises)[0]

    one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    aux = one()
    torch.cuda.synchronize()
    out["launches"] = dict(cuda_build.LAUNCHES)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    missing = [k for k in TRAIN_KERNELS if not out["launches"][k] > 0]
    if missing or not float(aux.p_dist.min()) > 0:
        raise AssertionError(f"perceptual cascade step: {missing} not "
                             f"launched ({out['launches']}) or p_dist "
                             f"{aux.p_dist.tolist()}")
    t = time.perf_counter()
    for _ in range(3):
        one()
    torch.cuda.synchronize()
    out["wall_ms"] = (time.perf_counter() - t) / 3 * 1e3
    out["profile"] = profile_ms(one)
    # a record, not a gate: two steps from one state, the same noise
    noises = tts.draw_cascade_noise(
        model, seq[1:], torch.Generator(device="cuda").manual_seed(3))
    params = []
    for _ in range(2):
        m = copy.deepcopy(model)
        st = tts.make_cascade_step(m, make_stage_optimizer(m, "all", 1e-4),
                                   _train_stage(perceptual=True),
                                   lambdas=LAMBDAS, dist_lambda=1.0,
                                   **pl_kwargs)
        st(seq[1:], seq[1:], make_dpb(seq[0]), noises)
        torch.cuda.synchronize()
        params.append({k: q.detach().clone()
                       for k, q in m.named_parameters()})
    out["repeat_differ"] = [k for k in params[0]
                            if not torch.equal(params[0][k], params[1][k])]
    del params
    losses = [float(one().loss.mean()) for _ in range(PL_GATE_STEPS)]
    out["gate_losses"] = losses
    if not (all(np.isfinite(losses))
            and np.mean(losses[-3:]) < np.mean(losses[:3])):
        raise AssertionError(f"perceptual step: the loss did not fall over "
                             f"{PL_GATE_STEPS} steps: {losses}")
    return out


def run_perceptual_loop(out_dir, smi):
    """Phase 11 (c): the trainer CLI over phase 10's tree with one
    all/cascade stage (2 epochs) whose perceptual field is true (the
    default SOLVER.PL_MODEL, resnet, seeded: no weights file ships)."""
    from vcm_ts_tpu_torch.ops import cuda_build

    root = os.path.join(out_dir, "perceptual_loop")
    cfg = write_loop_tree(root, PL_STAGES)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    rec, out["run_s"] = _trainer(["--config-file", cfg])
    out["launches"] = dict(cuda_build.LAUNCHES)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    epochs = rec["epochs"]
    losses = [v for it in rec["iterations"] for v in it["loss"]]
    with open(os.path.join(root, "run", "metrics.jsonl")) as f:
        p_dist = [r["value"] for r in map(json.loads, f)
                  if r["tag"].startswith("train/p_dist/")]
    missing = [k for k in TRAIN_KERNELS if not out["launches"][k] > 0]
    if (missing or [e["stage"] for e in epochs] != [0, 0]
            or not (losses and np.all(np.isfinite(losses)))
            or not (p_dist and min(p_dist) > 0)):
        raise AssertionError(f"perceptual trainer: launches "
                             f"{out['launches']}, epochs {epochs}, losses "
                             f"{losses}, p_dist {p_dist}")
    out["epochs"] = epochs
    out["p_dist"] = p_dist
    out["frames_per_s"] = epochs[1]["frames"] / epochs[1]["train_s"]
    out["first_frames_per_s"] = epochs[0]["frames"] / epochs[0]["train_s"]
    shutil.rmtree(root)
    return out


def run_rcnn(out_dir, smi):
    """Phase 11 (d): the Faster-RCNN eval detector on seeded v2-layout
    weights (91 classes; the class scores x RCNN_SCORE_GAIN) saved as a
    .pth and loaded by
    build_eval_adapter (min 1088 / max 1920), on phase 9's 1088x1920
    frames: the networks on the card against the CPU on one frame's
    preprocessed input and crops (within 1e-3 of each output's largest),
    the detections of the two devices side by side (printed), ms per frame
    by stage, pulls per frame; then benchmark_plot's rcnn branch over the
    frames."""
    from vcm_ts_tpu_torch import benchmark_plot as bp
    from vcm_ts_tpu_torch.eval import rcnn_native as rn
    from vcm_ts_tpu_torch.train.losses import seeded_init
    from vcm_ts_tpu_torch.utils.profiling import HostTimers

    path = os.path.join(out_dir, "rcnn_seeded.pth")
    seeded = seeded_init(rn.FasterRCNNNativeDetector(device="cpu"), 0)
    with torch.no_grad():
        # LeCun-normal class logits have a std of about 0.12 here: every
        # class would score under the 0.05 threshold and post-processing
        # would see no box
        seeded.roi_heads.box_predictor.cls_score.weight.mul_(RCNN_SCORE_GAIN)
    torch.save(seeded.state_dict(), path)
    adapter = rn.build_eval_adapter(path, device="cuda")
    det = adapter.detector
    cdet = rn.FasterRCNNNativeDetector.load_pth(path, device="cpu",
                                                min_size=1088, max_size=1920)
    frames = [_u8(f) for f in moving_frames(EVAL_FRAMES, H, W, seed=9)]
    out = {"frames": len(frames)}

    x, _ = det._preprocess(frames[0])
    cx, _ = cdet._preprocess(frames[0])
    out["preprocess_max_abs_err"] = float((x.cpu() - cx).abs().max())
    levels, rpn = det.forward_backbone(x)
    clevels, crpn = cdet.forward_backbone(x.cpu())
    errs = {}

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    for k, (a, b) in enumerate(zip(levels, clevels)):
        errs[f"level {rn.LEVELS[k]}"] = rel(a, b)
    for k, ((a, b), (c, d)) in enumerate(zip(rpn, crpn)):
        errs[f"rpn logits {rn.LEVELS[k]}"] = rel(a, c)
        errs[f"rpn deltas {rn.LEVELS[k]}"] = rel(b, d)
    crops = torch.randn((256, 256, 7, 7),
                        generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        gs, gd = det.roi_heads.box_predictor(
            det.roi_heads.box_head(crops.cuda()))
        cs, cd = cdet.roi_heads.box_predictor(cdet.roi_heads.box_head(crops))
    errs["box scores"], errs["box deltas"] = rel(gs, cs), rel(gd, cd)
    out["card_vs_cpu_max_rel"] = errs
    if not (max(errs.values()) <= 1e-3
            and out["preprocess_max_abs_err"] <= 1e-6):
        raise AssertionError(f"rcnn card vs CPU: {errs}, preprocess "
                             f"{out['preprocess_max_abs_err']}")

    # detections of the two devices on frame 0: the share of the CPU's
    # that the card finds too (same label, IoU >= 0.9); printed, not a
    # gate (a proposal at the top-1000 boundary may swap on a float)
    got, want = det.detect(frames[0]), cdet.detect(frames[0])

    def area(z):
        return np.prod(z[:, 2:] - z[:, :2], -1)

    def iou(a, b):
        lt = np.maximum(a[:, None, :2], b[None, :, :2])
        rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
        inter = np.prod(np.clip(rb - lt, 0, None), -1)
        return inter / (area(a)[:, None] + area(b)[None] - inter)

    same = (iou(want["boxes"], got["boxes"]) >= 0.9) & (
        want["labels"][:, None] == got["labels"][None])
    out["detections"] = {"cuda": len(got["labels"]),
                         "cpu": len(want["labels"]),
                         "cpu_found_on_card": float(same.any(1).mean())
                         if len(want["labels"]) else 1.0}

    def sane(o):
        b = o["boxes"]
        return (0 < len(o["labels"]) <= 100 and np.isfinite(b).all()
                and o["labels"].min() >= 1 and o["labels"].max() < 91
                and (b[:, [0, 2]] <= W).all() and (b[:, [1, 3]] <= H).all()
                and (b >= 0).all())

    timers = HostTimers()
    pulls = det.pulls
    for f in frames:
        o = det.detect(f, timers=timers)
        if not sane(o):
            raise AssertionError(f"rcnn detect: {o}")
    out["pulls_per_frame"] = (det.pulls - pulls) / len(frames)
    out["stage_ms"] = {k: v["mean_ms"] for k, v in timers.report().items()}
    decoded = [torch.from_numpy(f).cuda()[None].float() / 255 for f in frames]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for d in decoded:
        adapter(d)
    torch.cuda.synchronize()
    out["adapter_ms_per_frame"] = (time.perf_counter() - t) / len(frames) * 1e3
    if out["pulls_per_frame"] != 2:
        raise AssertionError(f"rcnn: {out['pulls_per_frame']} pulls a frame")

    branch = bp.build_rcnn("cuda", weights=path)
    branch(frames[0].astype(np.float32) / 255.0, 1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for f in frames:
        o = branch(f.astype(np.float32) / 255.0, 1)
        if not (o["labels"].min() >= 2 and np.isfinite(o["boxes"]).all()):
            raise AssertionError(f"benchmark_plot rcnn branch: {o}")
    out["branch_ms_per_frame"] = (time.perf_counter() - t) / len(frames) * 1e3
    os.remove(path)  # 160 MB
    return out


def run_perceptual(out_dir, smi, base_step):
    """Phase 11: (a)-(d) with their lines; returns the record."""
    t_phase = time.perf_counter()
    out = {"losses": check_perceptual_losses(smi)}
    t = time.perf_counter()
    out["step"] = s = run_perceptual_step(smi)
    p, b = s["profile"], base_step["profile"]
    say(f"[perceptual step] cascade step (p_frames 2, remat, 4x{TH}x{TW} "
        f"f32) with the ResNet loss (PL_LAMBDA 10): wall {s['wall_ms']:.1f} "
        f"ms (3 steps), profiled wall {p['wall_ms']:.1f} ms, device busy "
        f"{p['device_busy_ms']:.1f} ms, idle share {p['idle_share']:.3f}, "
        f"{p['launches']} launches, peak "
        f"{s['peak_bytes'] / 2**30:.2f} GiB; phase 8's step without it: "
        f"wall {b['wall_ms']:.1f} ms, busy {b['device_busy_ms']:.1f} ms, "
        f"{b['launches']} launches; port kernels' launches per step "
        f"{s['launches']}; loss over {PL_GATE_STEPS} steps "
        f"{s['gate_losses'][0]:.4f} -> {s['gate_losses'][-1]:.4f} "
        f"({time.perf_counter() - t:.1f} s; {smi})")
    top = ", ".join(f"{k['name'][:50]} {k['ms']:.1f} ms x{k['launches']}"
                    for k in p["top_kernels"][:6])
    say(f"[perceptual step] top kernels: {top}")
    d = s["repeat_differ"]
    say(f"[perceptual step] two steps with the ResNet loss from one state, "
        f"the same noise: parameters bit-identical {not d} ({len(d)} "
        f"tensors differ" + (f", e.g. {d[:5]}" if d else "") + ")")
    t = time.perf_counter()
    out["loop"] = lp = run_perceptual_loop(out_dir, smi)
    say(f"[perceptual trainloop] trainer CLI, stage "
        f"{'/'.join(PL_STAGES[0][:3])} x2 with the ResNet loss over "
        f"{LOOP_TRAIN} train / {LOOP_TEST} test sequences of {LOOP_T} "
        f"{TW}x{TH} tiles: epoch 1 {lp['frames_per_s']:.3f} frames/s "
        f"(epoch 0 {lp['first_frames_per_s']:.3f}), p_dist "
        f"{_g3(lp['p_dist'][:4])}, peak {lp['peak_bytes'] / 2**30:.2f} GiB, "
        f"launches {lp['launches']}, run {lp['run_s']:.1f} s "
        f"({time.perf_counter() - t:.1f} s; {smi})")
    t = time.perf_counter()
    out["rcnn"] = r = run_rcnn(out_dir, smi)
    stages = ", ".join(f"{k[len('rcnn_'):]} {v:.2f}"
                       for k, v in r["stage_ms"].items())
    say(f"[rcnn] {r['frames']} frames {W}x{H}, seeded 91 classes, min 1088 "
        f"/ max 1920: card vs CPU max rel err "
        f"{max(r['card_vs_cpu_max_rel'].values()):.3g} "
        f"({r['card_vs_cpu_max_rel']}); detections frame 0 card "
        f"{r['detections']['cuda']}, CPU {r['detections']['cpu']}, CPU's "
        f"found on the card {r['detections']['cpu_found_on_card']:.3f}; ms "
        f"per frame by stage (synchronized): {stages}; adapter "
        f"{r['adapter_ms_per_frame']:.1f} ms per frame; "
        f"{r['pulls_per_frame']:g} pulls per frame; benchmark_plot's rcnn "
        f"branch (min 800 / max 1333) {r['branch_ms_per_frame']:.1f} ms per "
        f"frame ({time.perf_counter() - t:.1f} s; {smi})")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------------------------------- phase 12
PAR_STAGES = [["2", "all", "cascade", "rec", "all", "0.0001", "2", "false"]]
PAR_RATES = 2  # phase 9's first two rate points (Q_ANCHORS)


def _par_batch(seed_rows):
    """(3, 4 * len(seed_rows), TH, TW, 3): phase 8's batch (seed 0) and,
    for more rows, further seeded blocks of 4 moving sequences."""
    return torch.cat([_train_batch(TH, TW, seed=s) for s in seed_rows], 1)


def _par_noise(model, seq):
    """A cascade step's noise for the global rows of seq, drawn on the
    card from a fixed seed (phase 8's draw), on the CPU."""
    from vcm_ts_tpu_torch.train import train_step as tts

    g = torch.Generator(device="cuda").manual_seed(0)
    noises = tts.draw_cascade_noise(model, seq[1:].cuda(), g)
    return [tuple(t.cpu() for t in n) for n in noises]


def par_steps(spec):
    """In each rank (or, with no process group, alone): phase 8's cascade
    step (published widths, p_frames 2, remat, f32, lr 1e-4) from the
    seeded DMC on this rank's rows of spec["seq"] with spec["noise"], for
    each mode of spec["modes"] ("plain": no mesh, the rows given; "dp";
    "fsdp"), twice from the same state: the first warms up, the second is
    timed (wall ms, peak memory, the kernel launches of that step alone,
    and under dp the ms of reduce_gradients, synchronized on both
    sides). With spec["probe"], first whether gloo takes CUDA tensors in
    reduce_scatter_tensor and all_gather_into_tensor (FSDP's collectives);
    fsdp runs only if it does."""
    import torch.distributed as dist

    from vcm_ts_tpu_torch.models.dmc import make_dpb
    from vcm_ts_tpu_torch.ops import cuda_build
    from vcm_ts_tpu_torch.parallel import mesh as pm
    from vcm_ts_tpu_torch.parallel.tensor import shard_params_fsdp
    from vcm_ts_tpu_torch.train import train_step as tts
    from vcm_ts_tpu_torch.train.optimizer import make_stage_optimizer
    from vcm_ts_tpu_torch.utils.device import set_codec_numerics
    from vcm_ts_tpu_torch.utils.weights import make_dmc

    set_codec_numerics()
    dev = pm.local_device("cuda")
    out = {"modes": {}}
    modes = list(spec["modes"])
    if spec.get("probe"):
        out["probe"] = {}
        x = torch.ones(4, device=dev)
        for name, call in (
                ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                    torch.empty(2, device=dev), x)),
                ("all_gather_into_tensor",
                 lambda: dist.all_gather_into_tensor(
                     torch.empty(8, device=dev), x[:4]))):
            try:
                call()
                torch.cuda.synchronize(dev)
                out["probe"][name] = "ok"
            except RuntimeError as e:
                out["probe"][name] = str(e).splitlines()[0][:200]
        if any(v != "ok" for v in out["probe"].values()):
            modes.remove("fsdp")
    for mode in modes:
        for timed in (False, True):
            model = make_dmc(dev)
            mesh = None
            if mode != "plain":
                mesh = pm.make_global_mesh(device_type="cuda")
                if mode == "fsdp":
                    shard_params_fsdp(model, mesh)
            opt = make_stage_optimizer(model, "all", 1e-4)
            step = tts.make_cascade_step(model, opt, _train_stage(),
                                         lambdas=LAMBDAS, dist_lambda=1.0,
                                         pl_lambda=0.0, mesh=mesh)
            rows = (pm.global_batch if mesh is not None
                    else (lambda v, **k: v))
            seq = rows(spec["seq"], batch_dim=1).to(dev)
            noise = [tuple(rows(t).to(dev) for t in n)
                     for n in spec["noise"]]
            reduce_ms = []
            reduce0 = pm.reduce_gradients

            def reduce_timed(*a, **k):
                torch.cuda.synchronize(dev)
                t = time.perf_counter()
                r = reduce0(*a, **k)
                torch.cuda.synchronize(dev)
                reduce_ms.append(1e3 * (time.perf_counter() - t))
                return r

            pm.reduce_gradients = reduce_timed
            try:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                cuda_build.reset_launches()
                t = time.perf_counter()
                aux, _ = step(seq[1:], seq[1:], make_dpb(seq[0]), noise)
                torch.cuda.synchronize(dev)
                wall = 1e3 * (time.perf_counter() - t)
            finally:
                pm.reduce_gradients = reduce0
            if not timed:
                continue
            out["modes"][mode] = {
                "wall_ms": wall, "reduce_ms": reduce_ms,
                "peak_bytes": torch.cuda.max_memory_allocated(dev),
                "launches": dict(cuda_build.LAUNCHES),
                "aux": {f: getattr(aux, f).cpu() for f in
                        tts.FrameAux._fields},
                "mu": {k: v.cpu() for k, v in opt.state_dict()["mu"].items()},
                "params": pm.host_copy(model)}
    return out


def _par_gate(got, want, label):
    """Phase 8's card-against-card tolerance (train_reference): FrameAux
    rtol 1e-3, gradients (first moments) within 2e-2 of each leaf's
    largest magnitude, parameters within 1e-6 + 0.05 lr where |g| is
    above 4e-2 of its leaf's largest, 2.1 lr elsewhere. Returns the
    largest errors."""
    lr = 1e-4
    err = {"aux": 0.0, "grad": 0.0, "param": 0.0}
    for f, b in want["aux"].items():
        a = got["aux"][f]
        e = float(((a - b).abs() / b.abs().clamp_min(1e-6)).max())
        err["aux"] = max(err["aux"], e)
        if not e <= 1e-3:
            raise AssertionError(f"{label}: {f} {a.tolist()} vs {b.tolist()}")
    for k, m in want["mu"].items():
        scale = max(float(m.abs().max()), 1e-30)
        e = float((got["mu"][k] - m).abs().max()) / scale
        err["grad"] = max(err["grad"], e)
        if not e <= 2e-2:
            raise AssertionError(f"{label}: gradient {k} off by {e} of its "
                                 "scale")
        firm = m.abs() > 4e-2 * scale
        d = (got["params"][k] - want["params"][k]).abs()
        tol = torch.where(firm, torch.full_like(d, 1e-6 + 0.05 * lr),
                          torch.full_like(d, 2.1 * lr))
        if not bool((d <= tol).all()):
            raise AssertionError(f"{label}: parameter {k} off by "
                                 f"{float(d.max())}")
        err["param"] = max(err["param"], float(d.max()))
    return err


def par_jobs(trainer_argv, video_argv):
    """A gloo rank sharing the card: trainer_multi's main over phase 10's
    tree, then test_video's main over phase 9's frames; each with its own
    launches and wall seconds."""
    import sys as _sys

    from vcm_ts_tpu_torch import test_video, trainer_multi
    from vcm_ts_tpu_torch.ops import cuda_build

    _sys.modules["torch.utils.tensorboard"] = None  # as on a card without
    out = {}
    for name, call in (("trainer", lambda: trainer_multi.main(trainer_argv)),
                       ("video", lambda: test_video.main(video_argv))):
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t = time.perf_counter()
        rec = call()
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t, "record": rec,
                     "launches": dict(cuda_build.LAUNCHES)}
        torch.cuda.empty_cache()  # two ranks' 1088x1920 codecs come next
    return out


def _add_launches(*counts):
    total = {}
    for c in counts:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def _need(launches, names, label):
    missing = [k for k in names if not launches.get(k, 0) > 0]
    if missing:
        raise AssertionError(f"{label}: {missing} not launched: {launches}")


CODEC_KERNELS = ("warp", "subpel_conv1x1", "pixel_shuffle_relayout")


def run_fleet():
    """An I + P batch at N = 2 (1088x1920, f32, real streams) through
    codecs with set_fleet_sharding(["cuda:0", "cuda:0"]) (each replica on
    its own thread and CUDA stream) against the unsharded batch: the same
    streams, recon and DPB. Launches of the fleet run."""
    from vcm_ts_tpu_torch.codec.engine import IntraCodec, VideoCodec
    from vcm_ts_tpu_torch.models.dmc import make_dpb
    from vcm_ts_tpu_torch.ops import cuda_build
    from vcm_ts_tpu_torch.utils.weights import make_dmc, make_intra

    plain = (IntraCodec(make_intra("cuda")), VideoCodec(make_dmc("cuda")))
    fleet = tuple(type(c)(copy.deepcopy(c.model)) for c in plain)
    for c in plain + fleet:
        c.update()
    for c in fleet:
        c.set_fleet_sharding(["cuda:0", "cuda:0"])
    frames = [torch.cat([f, f]) for f in moving_frames(2, H, W, seed=12)]
    iq = np.asarray(SERVE_IQ, np.float32).reshape(-1, 1, 1, 1)
    pq = np.asarray(SERVE_PQ, np.float32).reshape(-1, 1, 1, 1)
    res = {}
    for tag, (ic, vc) in (("plain", plain), ("fleet", fleet)):
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t = time.perf_counter()
        i_streams = ic.compress_batch(frames[0], iq)
        recon = ic.decompress_batch(i_streams, H, W, iq)
        dpb = make_dpb(torch.clamp(recon, 0, 1))
        enc = vc.compress_batch(frames[1], dpb, pq, pq, True)
        dec = vc.decompress_batch(dpb, enc["bit_streams"], H, W, pq, pq,
                                  True)
        torch.cuda.synchronize()
        res[tag] = {"s": time.perf_counter() - t, "streams": i_streams
                    + enc["bit_streams"], "recon": recon,
                    "dpb": dec["dpb"], "enc_dpb": enc["dpb"],
                    "launches": dict(cuda_build.LAUNCHES)}
    a, b = res["plain"], res["fleet"]
    same = {"streams": [x == y for x, y in zip(a["streams"], b["streams"])],
            "I recon": torch.equal(a["recon"], b["recon"]),
            **{f"DPB {k}": torch.equal(a["dpb"][k], b["dpb"][k])
               for k in a["dpb"]},
            **{f"encoder DPB {k}": torch.equal(b["enc_dpb"][k], b["dpb"][k])
               for k in a["dpb"]}}
    if not all(v if isinstance(v, bool) else all(v)
               for v in same.values()):
        raise AssertionError(f"fleet against the unsharded batch: {same}")
    _need(b["launches"], CODEC_KERNELS, "fleet")
    return {"plain_s": a["s"], "fleet_s": b["s"],
            "bytes": sum(len(x) for x in a["streams"]),
            "launches": b["launches"]}


def run_parallel(out_dir, smi, evaluation):
    """Phase 12: data-parallel and FSDP training, trainer_multi, the
    harness's rank split and fleet serving on the card, with gates."""
    from vcm_ts_tpu_torch.models.dmc import DMC
    from vcm_ts_tpu_torch.parallel.spawn import run_ranks
    from vcm_ts_tpu_torch.train.checkpoint import CheckPointer
    from vcm_ts_tpu_torch.utils.weights import make_dmc

    t_phase = time.perf_counter()
    j = os.path.join
    out = {}
    # the ranks are processes of their own: hand them the memory that
    # this process's allocator still caches from the earlier phases
    torch.cuda.empty_cache()
    # 12.1: one NCCL rank: the plain step, DP and FSDP from one state
    seq4 = _par_batch([0])
    spec = {"seq": seq4, "noise": _par_noise(make_dmc("cuda"), seq4),
            "modes": ["plain", "dp", "fsdp"]}
    t = time.perf_counter()
    one = run_ranks(par_steps, 1, spec, backend="nccl", device="cuda",
                    timeout=300)[0]["result"]["modes"]
    out["nccl1_s"] = time.perf_counter() - t
    out["nccl1"] = {m: {k: one[m][k] for k in ("wall_ms", "peak_bytes",
                                                "launches", "reduce_ms")}
                    for m in one}
    for m in ("dp", "fsdp"):
        _need(one[m]["launches"], TRAIN_KERNELS, f"1-rank NCCL {m} step")
        out["nccl1"][m]["err"] = _par_gate(one[m], one["plain"],
                                           f"1-rank NCCL {m} vs plain")
    say("[parallel] 1 NCCL rank, phase 8's cascade step (4x256x256, "
        "p_frames 2, f32): " + "; ".join(
            f"{m} wall {v['wall_ms']:.1f} ms, peak "
            f"{v['peak_bytes'] / 2**30:.2f} GiB"
            + (f", vs plain {v['err']}" if "err" in v else "")
            for m, v in out["nccl1"].items())
        + f" ({out['nccl1_s']:.1f} s; {smi})")

    # 12.2-12.4: two gloo ranks sharing the card
    seq8 = _par_batch([0, 4])
    spec8 = {"seq": seq8, "noise": _par_noise(make_dmc("cuda"), seq8),
             "modes": ["dp", "fsdp"], "probe": True}
    want = par_steps(dict(spec8, modes=["plain"], probe=False))[
        "modes"]["plain"]
    root = j(out_dir, "parallel")
    shutil.rmtree(root, ignore_errors=True)
    cfg = write_loop_tree(root, PAR_STAGES)
    ev = evaluation["root"]
    q = [str(v) for v in Q_ANCHORS[:PAR_RATES]]
    video_argv = ["--test_config", j(ev, "test.json"),
                  "--i_frame_model_path", j(ev, "intra.pth"),
                  "--model_path", j(ev, "dmc.pth"), "--rate_num",
                  str(PAR_RATES), "--i_frame_q_scales", *q,
                  "--p_frame_y_q_scales", *q, "--p_frame_mv_y_q_scales", *q,
                  "--write_stream", "1", "--output_path",
                  j(root, "video.json"), "--stream_path", j(root, "bin")]
    trainer_argv = ["--device", "cuda", "--config-file", cfg]
    torch.cuda.empty_cache()
    t = time.perf_counter()
    steps = [r["result"] for r in run_ranks(
        par_steps, 2, spec8, backend="gloo", device="cuda", timeout=300)]
    out["gloo2_steps_s"] = time.perf_counter() - t
    probe = steps[0]["probe"]
    out["gloo_probe"] = probe
    out["gloo2"] = {}
    for m in steps[0]["modes"]:
        v = [r["modes"][m] for r in steps]
        out["gloo2"][m] = {
            "wall_ms": [x["wall_ms"] for x in v],
            "reduce_ms": [x["reduce_ms"] for x in v],
            "peak_bytes": [x["peak_bytes"] for x in v],
            "launches": _add_launches(*(x["launches"] for x in v)),
            "err": [_par_gate(x, want, f"2 gloo ranks {m}, rank {i}, vs "
                              "the 8-row step") for i, x in enumerate(v)]}
        _need(out["gloo2"][m]["launches"], TRAIN_KERNELS,
              f"2 gloo ranks {m}")
    say(f"[parallel] gloo on CUDA tensors: {probe}; 2 gloo ranks sharing "
        "the card (4 rows each) against one process on the 8 global rows: "
        + "; ".join(f"{m} wall {v['wall_ms']} ms, reduce_gradients "
                    f"(host-staged gloo all-reduce, not a scaling figure) "
                    f"{v['reduce_ms']} ms, errors {v['err']}"
                    for m, v in out["gloo2"].items())
        + f"; the 8-row plain step {want['wall_ms']:.1f} ms ({smi})")
    out["plain8_wall_ms"] = want["wall_ms"]

    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = [r["result"] for r in run_ranks(
        par_jobs, 2, trainer_argv, video_argv, backend="gloo",
        device="cuda", timeout=600)]
    out["gloo2_jobs_s"] = time.perf_counter() - t
    tr = [r["trainer"] for r in ranks]
    epochs = tr[0]["record"]["epochs"]
    if [e["stage"] for e in epochs] != [0, 0]:
        raise AssertionError(f"trainer_multi: epochs {epochs}")
    for e in range(len(epochs)):
        m = DMC(device="cpu")
        CheckPointer().load(m, path=j(root, "run",
                                      f"model_epoch_{e:03d}.pt"))
    # frames/s of the global batch in each rank's record: the ranks start
    # an epoch's clock together and record the slowest rank's seconds, so
    # the two must agree
    out["trainer"] = {
        "s": [x["s"] for x in tr], "epochs": epochs,
        "frames_per_s": [[e["frames"] / e["train_s"]
                          for e in x["record"]["epochs"]] for x in tr],
        "launches": _add_launches(*(x["launches"] for x in tr))}
    _need(out["trainer"]["launches"], TRAIN_KERNELS, "trainer_multi")
    if out["trainer"]["frames_per_s"][0] != out["trainer"]["frames_per_s"][1]:
        raise AssertionError("trainer_multi: the ranks' epoch records give "
                             f"other frames/s: {out['trainer']}")
    say(f"[parallel] trainer_multi, 2 gloo ranks on the card, phase 10's "
        f"tree, all/cascade x2: frames/s of the global batch per epoch "
        f"(both ranks' records) {_g3(out['trainer']['frames_per_s'][0])}; "
        f"rank 0's "
        f"{len(epochs)} checkpoints load strict; launches "
        f"{out['trainer']['launches']} ({smi})")

    vr = [r["video"] for r in ranks]
    for rate in range(PAR_RATES):
        for f in range(EVAL_FRAMES):
            a = j(ev, "seq_bin", "images", str(rate), f"{f}.bin")
            b = j(root, "bin", "images", str(rate), f"{f}.bin")
            with open(a, "rb") as fa, open(b, "rb") as fb:
                if fa.read() != fb.read():
                    raise AssertionError(f"test_video ranks: rate {rate} "
                                         f"frame {f} .bin differs from "
                                         "phase 9's one-process run")
    out["video"] = {"s": [x["s"] for x in vr],
                    "launches": _add_launches(*(x["launches"] for x in vr))}
    _need(out["video"]["launches"], CODEC_KERNELS, "test_video ranks")
    say(f"[parallel] test_video, 2 ranks (tasks[rank::2]) over phase 9's "
        f"{EVAL_FRAMES} 1088x1920 frames, {PAR_RATES} rate points: every "
        f".bin equals phase 9's one-process run; {out['video']['s']} s "
        f"({smi})")

    out["fleet"] = run_fleet()
    say(f"[parallel] fleet over [cuda:0, cuda:0], I + P at N=2 "
        f"1088x1920: streams, recon and DPB equal the unsharded batch; "
        f"{out['fleet']['fleet_s']:.2f} s against "
        f"{out['fleet']['plain_s']:.2f} s ({smi})")
    out["launches"] = _add_launches(
        *(out["nccl1"][m]["launches"] for m in ("dp", "fsdp")),
        *(v["launches"] for v in out["gloo2"].values()),
        out["trainer"]["launches"], out["video"]["launches"],
        out["fleet"]["launches"])
    shutil.rmtree(root)
    shutil.rmtree(ev)  # phase 9's tree
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------------------------------- phase 13
# Kernel C's main-path calls at 1088x1920, the 3x3 SubpelConv sites of the
# DMC (models/video_net.py: the context fusion's conv3_up and conv2_up,
# the contextual decoder's up1-up4): (features C, input H, W).
RELAYOUT_SITES = (
    (64, H // 16, W // 16),  # decoder up1
    (64, H // 8, W // 8),    # decoder up2
    (64, H // 4, W // 4),    # decoder up3, context fusion conv3_up
    (64, H // 2, W // 2),    # context fusion conv2_up
    (32, H // 2, W // 2),    # decoder up4
)
TP_WIDTHS = (2, 4)
TP_RANKS = 2  # gloo ranks sharing the card


def _tp_slices(c):
    """(n, C / n) of each model axis that splits C features
    (parallel/tensor.tp_split)."""
    return [(n, c // n) for n in TP_WIDTHS if c % n == 0 and c >= n]


def check_tp_slices(g):
    """Kernels B and C at the slices that tensor parallelism gives each
    rank (n = 2 and 4) of every main-path site, f32 and bf16, against
    their plain versions (B within phase 2's tolerance; C bit-equal),
    with device times, the library yardsticks of phase 2 on the slice
    (cuDNN's 1x1 conv without the shuffle; F.pixel_shuffle) and bounds. A slice with r*r*C <= 16 takes kernel
    B's narrow path (csrc/subpel_conv1x1.cu)."""
    from vcm_ts_tpu_torch.ops import subpel as ts

    rows = []
    seen = set()
    for cin, c, h, w, _ in CONV1X1_SHAPES:
        for n, cs in _tp_slices(c):
            for dtype in (torch.float32, torch.bfloat16):
                if (cin, cs, h, w, dtype) in seen:
                    continue
                seen.add((cin, cs, h, w, dtype))
                x = torch.randn((1, cin, h, w), device="cuda",
                                generator=g).to(dtype=dtype, memory_format=CL)
                wk = (torch.randn((4, cin, cs), device="cuda", generator=g)
                      / cin ** 0.5).to(dtype)
                bk = (torch.randn((4, cs), device="cuda", generator=g)
                      * 0.1).to(dtype)
                got = ts.subpel_conv1x1_cuda(x, wk, bk, 2)
                want = ts.subpel_conv1x1_plain(x, wk, bk, 2)
                err = float((got.float() - want.float()).abs().max())
                scale = max(1.0, float(want.float().abs().max()))
                tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6 * scale
                label = (f"{cin}->{c}/{n}={cs} at {h}x{w} {str(dtype)[6:]}"
                         + (" narrow" if 4 * cs <= 16 else ""))
                if not err <= tol:
                    raise AssertionError(f"subpel_conv1x1 TP slice {label}: "
                                         f"max_abs_err {err} > {tol}")
                w4 = wk.permute(0, 2, 1).reshape(4 * cs, cin, 1, 1).contiguous(
                    memory_format=CL)
                b4 = bk.reshape(4 * cs)
                t = times(lambda: ts.subpel_conv1x1_cuda(x, wk, bk, 2),
                          lambda: ts.subpel_conv1x1_plain(x, wk, bk, 2),
                          lambda: F.conv2d(x, w4, b4))
                b, by = bound_ms(nbytes(x, wk, bk, got),
                                 2 * h * w * cin * 4 * cs, dtype)
                rows.append(dict(name="subpel_conv1x1", shape=label,
                                 dtype=str(dtype)[6:], max_abs_err=err,
                                 tol=tol, **t, library="F.conv2d 1x1 "
                                 "(channels_last, bias, no shuffle; cuDNN)",
                                 bound_ms=b, bound_by=by))
    for c, h, w in RELAYOUT_SITES:
        for n, cs in _tp_slices(c):
            for dtype in (torch.float32, torch.bfloat16):
                if (cs, h, w, dtype) in seen:
                    continue
                seen.add((cs, h, w, dtype))
                x = torch.randn((1, 4 * cs, h, w), device="cuda",
                                generator=g).to(dtype=dtype, memory_format=CL)
                got = ts.relayout_cuda(x, 2)
                label = f"C={c}/{n}={cs} {h}x{w} {str(dtype)[6:]}"
                if not torch.equal(got, ts.relayout_plain(x, 2)):
                    raise AssertionError(f"relayout TP slice {label}: not "
                                         "bit-identical to the plain version")
                xc = x.reshape(1, 4, cs, h, w).transpose(1, 2).reshape(
                    1, 4 * cs, h, w).contiguous(memory_format=CL)
                t = times(lambda: ts.relayout_cuda(x, 2),
                          lambda: ts.relayout_plain(x, 2),
                          lambda: F.pixel_shuffle(xc, 2))
                b, by = bound_ms(2 * nbytes(x), 0, dtype)
                rows.append(dict(name="pixel_shuffle_relayout", shape=label,
                                 dtype=str(dtype)[6:], max_abs_err=0.0,
                                 tol=0.0, **t,
                                 library="F.pixel_shuffle (c-major input)",
                                 bound_ms=b, bound_by=by))
    return rows


def _tp_inputs():
    """Phase 8's first sequence at 256x256 (frame 1 coded against frame
    0, the I-frame model's input), on the CPU."""
    seq = _par_batch([0])
    return {"x": seq[1, :1], "ref": seq[0, :1], "seq": seq}


def tp_forwards(models, inp, mesh=None):
    """The DMC's forward (is_first_p, q-scales PQ) and IntraNoAR's (q-scale
    IQ) at 256x256 without gradients: outputs on the CPU, wall ms of each
    (synchronized) and, split over `mesh`, through parallel/tensor's
    tp_forward."""
    from vcm_ts_tpu_torch.models.dmc import make_dpb
    from vcm_ts_tpu_torch.parallel import tensor as tp

    intra, dmc = models
    dev = next(dmc.parameters()).device
    x, ref = inp["x"].to(dev), inp["ref"].to(dev)
    if mesh is not None:
        fwd = tp.tp_forward(dmc, mesh, is_first_p=True)
    else:
        def fwd(*args):
            with torch.no_grad():
                return dmc(*args, True, training=False)
    out = {}
    for name, call in (
            ("dmc", lambda: fwd(x, make_dpb(ref), PQ, PQ)),
            ("intra", lambda: intra(ref, torch.full((1, 1, 1, 1), IQ,
                                                    device=dev)))):
        with torch.no_grad():
            call()  # cuDNN plans
            torch.cuda.synchronize(dev)
            tp.reset_collectives()
            t = time.perf_counter()
            res = call()
            torch.cuda.synchronize(dev)
        key = "ref_frame" if name == "dmc" else "x_hat"
        img = res["dpb"]["ref_frame"] if name == "dmc" else res["x_hat"]
        out[name] = {key: img.cpu(), "bpp": res["bpp"].cpu(),
                     "wall_ms": 1e3 * (time.perf_counter() - t),
                     "collectives": dict(tp.COLLECTIVES)}
    return out


def tp_rank(spec):
    """In each of TP_RANKS gloo ranks sharing the card: the seeded IntraNoAR
    and DMC (published widths) split over a 1 x TP_RANKS data x model mesh
    (parameter and Adam-moment bytes this rank holds, against the whole
    model's), tp_forwards, then phase 8's cascade step (4x256x256,
    p_frames 2, remat, f32) on every row (the model group's rows) from
    the seeded state, twice (the first warms up; the second is timed:
    wall ms, the kernel launches and collectives of that step alone,
    FrameAux, the gathered first moments and parameters)."""
    from vcm_ts_tpu_torch.models.dmc import make_dpb
    from vcm_ts_tpu_torch.ops import cuda_build
    from vcm_ts_tpu_torch.parallel import mesh as pm
    from vcm_ts_tpu_torch.parallel import tensor as tp
    from vcm_ts_tpu_torch.train import train_step as tts
    from vcm_ts_tpu_torch.train.optimizer import make_stage_optimizer
    from vcm_ts_tpu_torch.utils.device import set_codec_numerics
    from vcm_ts_tpu_torch.utils.weights import make_dmc, make_intra

    set_codec_numerics()
    dev = pm.local_device("cuda")
    mesh = pm.make_dp_tp_mesh(1, pm.get_world_size(), device_type="cuda")
    out = {"bytes": {}}

    def split(model):
        whole = sum(p.numel() * p.element_size() for p in model.parameters())
        n = tp.shard_params_tp(model, mesh)
        mine = sum(p.numel() * p.element_size() for p in model.parameters())
        return n, whole, mine

    intra, dmc = make_intra(dev), make_dmc(dev)
    for name, model in (("intra", intra), ("dmc", dmc)):
        n, whole, mine = split(model)
        out["bytes"][name] = {"n_split": n, "whole": whole, "rank": mine}
    cuda_build.reset_launches()
    out["forward"] = tp_forwards((intra, dmc), spec, mesh)
    out["forward_launches"] = dict(cuda_build.LAUNCHES)
    del intra, dmc
    torch.cuda.empty_cache()

    seq = spec["seq"].to(dev)
    noise = [tuple(t.to(dev) for t in n) for n in spec["noise"]]
    whole_grads = {}
    broadcast0 = pm.broadcast_whole_grads

    def broadcast_seen(grads, split, mesh):
        # the whole parameters' gradients as this rank computed them
        whole_grads.update({n: g.detach().cpu() for n, g in grads.items()
                            if g is not None and n not in split})
        return broadcast0(grads, split, mesh)

    pm.broadcast_whole_grads = broadcast_seen
    for timed in (False, True):
        model = make_dmc(dev)
        n_split, whole, mine = split(model)
        opt = make_stage_optimizer(model, "all", 1e-4)
        moments = sum(2 * m.numel() * m.element_size()
                      for m in opt.mu.values())
        step = tts.make_cascade_step(model, opt, _train_stage(),
                                     lambdas=LAMBDAS, dist_lambda=1.0,
                                     pl_lambda=0.0, mesh=mesh)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        cuda_build.reset_launches()
        tp.reset_collectives()
        t = time.perf_counter()
        aux, _ = step(seq[1:], seq[1:], make_dpb(seq[0]), noise)
        torch.cuda.synchronize(dev)
        wall = 1e3 * (time.perf_counter() - t)
    out["step"] = {
        "wall_ms": wall, "peak_bytes": torch.cuda.max_memory_allocated(dev),
        "launches": dict(cuda_build.LAUNCHES),
        "collectives": dict(tp.COLLECTIVES),
        "param_bytes": {"whole": whole, "rank": mine},
        "moment_bytes": {"rank": moments},
        "aux": {f: getattr(aux, f).cpu() for f in tts.FrameAux._fields},
        "opt": opt.state_dict(), "whole_grads": whole_grads,
        "params": pm.host_copy(model)}
    out["step"]["mu"] = out["step"]["opt"]["mu"]
    return out


def run_tp(smi, g):
    """Phase 13: tensor parallelism on the card, with gates."""
    from vcm_ts_tpu_torch.parallel.spawn import run_ranks
    from vcm_ts_tpu_torch.utils.weights import make_dmc, make_intra

    t_phase = time.perf_counter()
    out = {"rows": check_tp_slices(g)}
    say_rows(out["rows"])
    inp = _tp_inputs()
    inp["noise"] = _par_noise(make_dmc("cuda"), inp["seq"])
    want_fwd = tp_forwards((make_intra("cuda"), make_dmc("cuda")), inp)
    want = par_steps({"seq": inp["seq"], "noise": inp["noise"],
                      "modes": ["plain"]})["modes"]["plain"]
    whole_moments = 2 * sum(v.numel() * v.element_size()
                            for v in want["mu"].values())
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = [r["result"] for r in run_ranks(
        tp_rank, TP_RANKS, inp, backend="gloo", device="cuda", timeout=600)]
    out["ranks_s"] = time.perf_counter() - t
    # the forwards: one whole output on both ranks, the unsharded one's
    # within phase 8's card-against-card rtol 1e-3 (bpp) and 1e-3 of the
    # image's largest (the 3-channel output)
    out["forward_err"] = {}
    for name, key in (("dmc", "ref_frame"), ("intra", "x_hat")):
        a = want_fwd[name]
        for i, r in enumerate(ranks):
            b = r["forward"][name]
            e_img = float((b[key] - a[key]).abs().max())
            e_bpp = float(((b["bpp"] - a["bpp"]).abs()
                           / a["bpp"].abs().clamp_min(1e-6)).max())
            if not (e_img <= 1e-3 * float(a[key].abs().max())
                    and e_bpp <= 1e-3):
                raise AssertionError(f"TP forward {name}, rank {i}: {key} "
                                     f"off by {e_img}, bpp by {e_bpp}")
            out["forward_err"][f"{name} rank {i}"] = (e_img, e_bpp)
        if not torch.equal(ranks[0]["forward"][name][key],
                           ranks[1]["forward"][name][key]):
            raise AssertionError(f"TP forward {name}: the ranks' whole "
                                 "outputs differ")
    out["step_err"] = [_par_gate(r["step"], want, f"TP={TP_RANKS} step, "
                                 f"rank {i}, vs the unsharded step")
                       for i, r in enumerate(ranks)]
    # one model group: after the step its ranks hold bit-equal whole
    # parameters and moments (model rank 0's whole-parameter gradients are
    # broadcast); how far the ranks' own gradients of those parameters
    # were apart before the broadcast is reported
    a, b = (r["step"] for r in ranks)
    for what in ("params", "mu", "nu"):
        x, y = ((s["params"] if what == "params" else s["opt"][what])
                for s in (a, b))
        differ = [k for k in x if not torch.equal(x[k], y[k])]
        if set(x) != set(y) or differ:
            raise AssertionError(f"TP={TP_RANKS} step: the ranks' whole "
                                 f"{what} differ ({differ[:4]})")
    out["whole_grad_gap"] = max(
        float((a["whole_grads"][k] - b["whole_grads"][k]).abs().max())
        for k in a["whole_grads"])
    out["whole_grads_equal"] = all(
        torch.equal(a["whole_grads"][k], b["whole_grads"][k])
        for k in a["whole_grads"])
    launches = _add_launches(*(r["forward_launches"] for r in ranks),
                             *(r["step"]["launches"] for r in ranks))
    _need(_add_launches(*(r["step"]["launches"] for r in ranks)),
          TRAIN_KERNELS, f"TP={TP_RANKS} cascade step")
    out["launches"] = launches
    out["bytes"] = ranks[0]["bytes"]
    out["step"] = {k: [r["step"][k] for r in ranks]
                   for k in ("wall_ms", "peak_bytes", "collectives",
                             "param_bytes", "moment_bytes", "launches")}
    out["forward"] = {
        name: {"wall_ms": [r["forward"][name]["wall_ms"] for r in ranks],
               "unsharded_wall_ms": want_fwd[name]["wall_ms"],
               "collectives": ranks[0]["forward"][name]["collectives"]}
        for name in ("dmc", "intra")}
    out["unsharded_step_ms"] = want["wall_ms"]
    out["whole_moment_bytes"] = whole_moments
    note = ("host-staged gloo on 2 ranks sharing one card: checks the "
            "arithmetic, not a TP speed")
    by = out["bytes"]
    say(f"[tp] per-rank parameter bytes of the {TP_RANKS}-way split: "
        + "; ".join(f"{k} {v['rank']} of {v['whole']} whole "
                    f"({v['rank'] / v['whole']:.3f}; {v['n_split']} "
                    "parameters split)" for k, v in by.items())
        + f"; DMC Adam moments {out['step']['moment_bytes'][0]['rank']} of "
        f"{whole_moments} whole ({smi})")
    say(f"[tp] TP={TP_RANKS} forwards at {TH}x{TW} against the unsharded "
        f"forwards (errors {out['forward_err']}): "
        + "; ".join(f"{k} wall {_g3(v['wall_ms'])} ms (unsharded "
                    f"{v['unsharded_wall_ms']:.1f} ms), collectives "
                    f"{v['collectives']}" for k, v in out["forward"].items())
        + f" ({note}; {smi})")
    say(f"[tp] TP={TP_RANKS} cascade step (phase 8's, {TN}x{TH}x{TW}, p_frames "
        f"2, f32) against the unsharded step: errors {out['step_err']}; "
        f"wall {_g3(out['step']['wall_ms'])} ms against "
        f"{want['wall_ms']:.1f} ms unsharded; collectives per step "
        f"{out['step']['collectives'][0]}; kernel launches per rank "
        f"{out['step']['launches'][0]}; peak "
        f"{_g3([b / 2**30 for b in out['step']['peak_bytes']])} GiB ({note};"
        f" {smi})")
    say(f"[tp] TP={TP_RANKS} cascade step: both ranks' whole parameters and "
        f"Adam moments bit-equal after the step; the gradients of the "
        f"{len(a['whole_grads'])} whole (unsplit) parameters as each rank "
        f"computed them, before model rank 0's broadcast: bit-equal "
        f"{out['whole_grads_equal']}, largest gap {out['whole_grad_gap']:.3g}"
        f" ({smi})")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------------------ phase 14
# the spatial mode's cases: (label, gloo ranks sharing the card, H, W,
# dtype, fast_warp, P-frames)
SP_CASES = (("f32 1088x1920", 2, H, W, "f32", False, 2),
            ("bf16 fast_warp 576x1024", 4, 576, 1024, "bf16", True, 1))
# planes of the DMC hooked on each rank (the mv hyper encoder's H/32 and
# H/64 outputs, the contextual hyper encoder's H/64 one): those that do
# not tile the ranks must be whole and bit-equal on every rank
SP_HOOKS = (("mv_hyper_prior_encoder", 6, 32), ("mv_hyper_prior_encoder", 8,
                                                 64),
            ("contextual_hyper_prior_encoder", 4, 64))


def check_spatial_windows(g):
    """Kernels A and D with a row window (spatial mode) at 1088x1920: every
    rank's window of the packed f32 warp (2 ranks) and of the 64-channel
    bf16 two-pass warp, D=24 (4 ranks), bit for bit the rows of the whole
    launch; one window timed against its plain version and, for A,
    F.grid_sample on the window's grid. Bound: the image rows the
    window's taps reach (from this flow), the flow's and the output's
    rows."""
    from vcm_ts_tpu_torch.ops import warp as tw
    from vcm_ts_tpu_torch.ops import warp_twopass as td

    rows = []
    ims = [torch.rand((1, c, H, W), device="cuda", generator=g).to(
        memory_format=CL) for c in (3, 64)]
    flow = make_flow("smooth", H, W, g)
    im16 = torch.rand((1, 64, H, W), device="cuda", generator=g).to(
        dtype=torch.bfloat16, memory_format=CL)
    d = 24
    flow_d = (torch.randn((1, 2, H, W), device="cuda", generator=g)
              * (1.5 * d)).to(memory_format=CL)
    whole_a = tw.warp_cuda(ims, flow)
    whole_d = td.warp_twopass_cuda(im16, flow_d, d)
    for name, n_ranks in (("warp", 2), ("warp_twopass", 4)):
        hl = H // n_ranks
        for r in range(n_ranks):
            r0 = r * hl
            f = (flow if name == "warp" else flow_d)[:, :, r0:r0 + hl]
            f = f.contiguous(memory_format=CL)
            if name == "warp":
                got = tw.warp_cuda(ims, f, row0=r0)
                want = [t[:, :, r0:r0 + hl] for t in whole_a]
            else:
                got = [td.warp_twopass_cuda(im16, f, d, row0=r0)]
                want = [whole_d[:, :, r0:r0 + hl]]
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name}: window {r} of {n_ranks} "
                                     "differs from the whole launch's rows")
        r0 = hl  # rank 1's window: rows above and below it are read
        f = (flow if name == "warp" else flow_d)[:, :, r0:r0 + hl]
        f = f.contiguous(memory_format=CL)
        if name == "warp":
            y0 = tw._clamped_coords(f, H, r0)[1]
            src, out = ims, tw.warp_cuda(ims, f, row0=r0)
            plain = tw.warp_plain(ims, f, row0=r0)
            cat = torch.cat(ims, 1)
            grid = _grid(f, row0=r0, h=H)
            t = times(lambda: tw.warp_cuda(ims, f, row0=r0),
                      lambda: tw.warp_plain(ims, f, row0=r0),
                      lambda: F.grid_sample(
                          cat, grid, mode="bilinear",
                          padding_mode="border", align_corners=True))
            flops = 11 * cat.shape[1] * hl * W
            label = (f"67ch packed (3+64) {H}x{W} f32, smooth flow, window "
                     f"rows {r0}:{r0 + hl} of {n_ranks} ranks")
            lib = "F.grid_sample(border, align_corners=True) on the window"
        else:
            y0 = torch.stack([q // W for q in td._taps(f, d, H, r0)[0]])
            src, out = [im16], [td.warp_twopass_cuda(im16, f, d, row0=r0)]
            plain = [td.warp_twopass_plain(im16, f, d, row0=r0)]
            t = times(lambda: td.warp_twopass_cuda(im16, f, d, row0=r0),
                      lambda: td.warp_twopass_plain(im16, f, d, row0=r0),
                      None)
            grid = _grid(f, row0=r0, h=H).to(torch.bfloat16)
            t.update(exact_warp_ms=graph_ms(
                lambda: tw.warp_cuda([im16], f, row0=r0)),
                grid_sample_ms=graph_ms(lambda: F.grid_sample(
                    im16, grid, mode="bilinear", padding_mode="border",
                    align_corners=True)),
                flow_beyond_d=float((f.abs() > d).float().mean()))
            flops = 9 * im16.shape[1] * hl * W
            label = (f"64ch {H}x{W} D={d} bf16, window rows {r0}:{r0 + hl} "
                     f"of {n_ranks} ranks")
            lib = None
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(out, plain))
        if err != 0.0:
            raise AssertionError(f"{name} window: plain version differs "
                                 f"by {err}")
        reach = int(y0.max()) + 2 - int(y0.min())  # rows the taps reach
        b, by = bound_ms(sum(nbytes(i) * min(reach, H) // H for i in src)
                         + nbytes(f, *out), flops, torch.float32)
        rows.append(dict(name=name, shape=label, max_abs_err=err, tol=0.0,
                         **t, library=lib, bound_ms=b, bound_by=by,
                         rows_reached=reach))
    return rows


def _sp_codecs(dev, dtype, fast_warp):
    """The seeded IntraNoAR and DMC (published widths) as codecs, tables
    built."""
    from vcm_ts_tpu_torch.codec.engine import IntraCodec, VideoCodec
    from vcm_ts_tpu_torch.utils.precision import cast_params
    from vcm_ts_tpu_torch.utils.weights import make_dmc, make_intra

    intra, dmc = make_intra(dev), make_dmc(dev, fast_warp=fast_warp)
    if dtype == "bf16":
        intra = cast_params(intra, torch.bfloat16)
        dmc = cast_params(dmc, torch.bfloat16)
    ic, vc = IntraCodec(intra, device=dev), VideoCodec(dmc, device=dev)
    ic.update()
    vc.update()
    return ic, vc


def sp_code(ic, vc, spec, whole, hooked=None):
    """I + P-frames of spec["frames"] (numpy, whole) through the codecs
    (spatial or not), each call timed (synchronized) with its
    collectives; the P chain starts from make_dpb(spec["dpb_ref"]) (the
    unsharded I recon: equal DPB state in both modes) or of its own I
    recon. Returns the streams, every decoded frame whole on the CPU,
    whether each P-frame's decode equals the encoder's recon, and the
    seconds and collectives of each call. `hooked`: planes recorded by
    hooks during P-frame 1's encode are kept from this dict."""
    from vcm_ts_tpu_torch.models.dmc import make_dpb
    from vcm_ts_tpu_torch.parallel import spatial as sp

    h, w, frames = spec["h"], spec["w"], spec["frames"]
    out = {"s": {}, "collectives": {}, "p": []}

    def timed(name, fn):
        torch.cuda.synchronize()
        sp.reset_collectives()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["s"][name] = time.perf_counter() - t
        out["collectives"][name] = dict(sp.COLLECTIVES)
        return res

    out["i_stream"] = timed("I encode", lambda: ic.compress(frames[0], IQ))
    rec0 = timed("I decode", lambda: ic.decompress(out["i_stream"], h, w,
                                                   IQ))
    out["i_recon"] = whole(rec0).cpu()
    ref = spec.get("dpb_ref")
    ref = out["i_recon"] if ref is None else ref
    out["dpb0"] = dpb0 = vc.spatial_shard_tree(make_dpb(ref.cuda()))
    dpb_e = dpb_d = dpb0
    for t in range(1, len(frames)):
        e = timed(f"P{t} encode", lambda: vc.compress(
            frames[t], dpb_e, PQ, PQ, t == 1))
        if t == 1 and hooked is not None:
            out["hooked"] = dict(hooked)
        d = timed(f"P{t} decode", lambda: vc.decompress(
            dpb_d, e["bit_stream"], h, w, PQ, PQ, t == 1))
        dpb_e, dpb_d = e["dpb"], d["dpb"]
        out["p"].append({
            "stream": e["bit_stream"],
            "dec_equals_enc": all(torch.equal(d["dpb"][k], e["dpb"][k])
                                  for k in e["dpb"]),
            "recon": whole(d["dpb"]["ref_frame"]).cpu()})
    return out


def spatial_rank(spec):
    """In each of spec["ranks"] gloo ranks sharing the card: the codecs
    split by rows (set_spatial_sharding), one warm-up I + P, then sp_code
    with the launches counted (reset just before it) and the DMC's hooked
    planes; then the unsharded run's streams decoded by the split
    decoder (I, then the P-frames through decode_gop), when the split
    encoder wrote the same bytes."""
    from vcm_ts_tpu_torch.ops import cuda_build
    from vcm_ts_tpu_torch.parallel import mesh as pm
    from vcm_ts_tpu_torch.parallel import spatial as sp

    dev = pm.local_device("cuda")
    ic, vc = _sp_codecs(dev, spec["dtype"], spec["fast_warp"])
    mesh = sp.make_spatial_mesh(device_type="cuda")
    ic.set_spatial_sharding(mesh)
    vc.set_spatial_sharding(mesh)
    h, w = spec["h"], spec["w"]

    def whole(t):
        return sp.gather_spatial(t, mesh, h, w)

    warm = dict(spec, frames=spec["frames"][:2])
    sp_code(ic, vc, warm, whole)  # cuDNN plans, tables
    hooked = {}
    hooks = [getattr(vc.model, mod)[i].register_forward_hook(
        lambda m, a, o, k=f"{mod}[{i}] H/{s}": hooked.__setitem__(
            k, o.detach().cpu())) for mod, i, s in SP_HOOKS]
    cuda_build.reset_launches()
    out = sp_code(ic, vc, spec, whole, hooked)
    out["launches"] = dict(cuda_build.LAUNCHES)
    for hook in hooks:
        hook.remove()
    plain = spec["plain"]
    same = (out["i_stream"] == plain["i_stream"]
            and out["p"][0]["stream"] == plain["p"][0]["stream"])
    out["decoded_plain"] = None
    if same:  # the unsharded streams, through the split decoder
        rec0 = ic.decompress(plain["i_stream"], h, w, IQ)
        recons, _ = vc.decode_gop(out["dpb0"],
                                  [p["stream"] for p in plain["p"]], h, w,
                                  PQ, PQ, True)
        torch.cuda.synchronize()
        out["decoded_plain"] = [whole(r).cpu() for r in [rec0] + recons]
    del out["dpb0"]
    return out


def _drift(a, b):
    """(largest |a - b|, share of bit-equal elements)."""
    return (float((a.float() - b.float()).abs().max()),
            float((a == b).float().mean()))


def run_spatial(smi, g):
    """Phase 14: the engines' spatial mode on gloo ranks sharing the card,
    with gates; kernels A and D with a row window."""
    from vcm_ts_tpu_torch.parallel.spatial import tiles
    from vcm_ts_tpu_torch.parallel.spawn import run_ranks

    t_phase = time.perf_counter()
    out = {"rows": check_spatial_windows(g), "cases": {}}
    say_rows(out["rows"])
    note = ("gloo ranks sharing one card, every gather staged through the "
            "host: checks the arithmetic; no NVLink or NCCL figure")
    launches = {}
    for label, n, h, w, dtype, fast_warp, n_p in SP_CASES:
        frames = [f.numpy() for f in moving_frames(n_p + 1, h, w, seed=14)]
        spec = {"frames": frames, "h": h, "w": w, "dtype": dtype,
                "fast_warp": fast_warp, "ranks": n}
        ic, vc = _sp_codecs("cuda", dtype, fast_warp)
        sp_code(ic, vc, dict(spec, frames=frames[:2]), lambda t: t)  # warm
        plain = sp_code(ic, vc, spec, lambda t: t)
        del ic, vc, plain["dpb0"]
        torch.cuda.empty_cache()
        spec.update(plain=plain, dpb_ref=plain["i_recon"])
        t = time.perf_counter()
        ranks = [r["result"] for r in run_ranks(
            spatial_rank, n, spec, backend="gloo", device="cuda",
            timeout=900)]
        ranks_s = time.perf_counter() - t
        first = ranks[0]
        # gates: the planes that do not tile the ranks are whole on every
        # rank and bit-equal
        whole_planes = {k: v for k, v in first["hooked"].items()
                        if not tiles(h // int(k.split("H/")[1]), n)}
        for k, v in whole_planes.items():
            if v.shape[2] != h // int(k.split("H/")[1]):
                raise AssertionError(f"[spatial {label}] {k}: "
                                     f"{v.shape[2]} rows, not whole")
        for i, r in enumerate(ranks):
            if (r["i_stream"] != first["i_stream"]
                    or [p["stream"] for p in r["p"]]
                    != [p["stream"] for p in first["p"]]):
                raise AssertionError(f"[spatial {label}] rank {i} wrote "
                                     "other bytes than rank 0")
            for t_, p in enumerate(r["p"]):
                if not p["dec_equals_enc"]:
                    raise AssertionError(
                        f"[spatial {label}] rank {i}, P-frame {t_ + 1}: the "
                        "split decoder's DPB differs from the encoder's")
            for k, v in whole_planes.items():
                if not torch.equal(r["hooked"][k], v):
                    raise AssertionError(f"[spatial {label}] the whole plane"
                                         f" {k} differs on rank {i}")
        recons = [first["i_recon"]] + [p["recon"] for p in first["p"]]
        for t_, rec in enumerate(recons):
            if rec.shape != (1, h, w, 3) or not torch.isfinite(
                    rec.float()).all():
                raise AssertionError(f"[spatial {label}] frame {t_}: bad "
                                     "decoded frame")
        same = {"I": first["i_stream"] == plain["i_stream"],
                "P1": first["p"][0]["stream"] == plain["p"][0]["stream"]}
        drift = None
        if dtype == "f32":  # (i): the cross-mode gates
            if not all(same.values()):
                raise AssertionError(f"[spatial {label}] streams differ "
                                     f"from the unsharded engine's: {same}")
            dec = first["decoded_plain"]
            if dec is None or len(dec) != len(recons):
                raise AssertionError(f"[spatial {label}] the split decoder "
                                     "did not decode the unsharded streams")
            plain_recons = ([plain["i_recon"]]
                            + [p["recon"] for p in plain["p"]])
            drift = [_drift(a, b) for a, b in zip(dec, plain_recons)]
        case = {
            "ranks": n, "ranks_s": ranks_s, "same_as_unsharded": same,
            "drift": drift, "bytes": [len(first["i_stream"])]
            + [len(p["stream"]) for p in first["p"]],
            "s": first["s"], "plain_s": plain["s"],
            "collectives": first["collectives"],
            "launches": [r["launches"] for r in ranks],
            "whole_planes": {k: tuple(v.shape) for k, v in
                             whole_planes.items()}}
        out["cases"][label] = case
        for r in ranks:
            launches = _add_launches(launches, r["launches"])
        _need(_add_launches(*case["launches"]),
              ("warp_twopass" if fast_warp else "warp", "subpel_conv1x1",
               "pixel_shuffle_relayout"), f"spatial {label}")
        walls = "; ".join(
            f"{k} {case['s'][k] * 1e3:.1f} ms (unsharded "
            f"{case['plain_s'][k] * 1e3:.1f})" for k in case["s"])
        say(f"[spatial] {label} on {n} ranks: I + {n_p} P, streams "
            f"{case['bytes']} B, equal to the unsharded engine's {same}, "
            f"every rank's bytes equal, each P-frame decoded to the "
            f"encoder's recon bit for bit, whole planes bit-equal across "
            f"ranks {case['whole_planes']}; the unsharded streams decoded "
            f"by the split decoder: recon drift (largest, bit-equal share) "
            f"{drift}; wall per call {walls}; ranks {ranks_s:.1f} s ({note};"
            f" {smi})")
        say(f"[spatial] {label}: collectives per call (rank 0) "
            f"{case['collectives']}; kernel launches per rank "
            f"{case['launches'][0]}")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------------------------------- phase 15
DET_STEPS = 30  # the overfit gate's steps on one fixed batch
DET_LOOP = 6  # steps of the timed loop, each on a freshly drawn batch
CTC_TOL = 1e-4  # card CTC against its plain version, of the largest value


def _det_trainers():
    """{name: (build, draw)} for the three trainers at their published
    sizes: build() -> (module, optimizer, step, owner) from the trainer's
    seeded init and optimizer; draw(rng) -> one host batch."""
    from vcm_ts_tpu_torch import train_face_detector as tfd
    from vcm_ts_tpu_torch import train_plate_detector as tpd
    from vcm_ts_tpu_torch import train_plate_ocr as tpo
    from vcm_ts_tpu_torch.eval.mtcnn_native import MTCNNNativeDetector
    from vcm_ts_tpu_torch.eval.ocr_native import PlateOCRNative

    def ocr():
        owner = PlateOCRNative.init_random(0, "cuda")
        model = tpo.freeze_input_bias(owner.model).train()
        opt = tpo.make_optimizer(model, 1e-3)
        return model, opt, tpo.make_step(model, opt), owner

    def plate():
        det = tpd.make_model(0, "cuda")
        opt = tpd.make_optimizer(det, 2e-3, DET_STEPS)
        return det, opt, tpd.make_step(det, opt), det

    def face(net_name, det=None):
        def build():
            owner = det or MTCNNNativeDetector(device="cuda").init(0)
            net = getattr(owner, net_name)
            opt = tfd.make_optimizer(net, 1e-3)
            return net, opt, tfd.make_step(net, opt), owner
        return build

    def face_draw(size):
        return lambda rng: tfd.pad_batch(*tfd.sample_crops(rng, 4, size),
                                         32)

    return {"plate_ocr": (ocr, lambda rng: tpo.make_batch(
                64, rng, tpo.WIDTH_BUCKETS[-1])[:3]),
            "plate_detector": (plate, lambda rng: tpd.make_batch(8, rng)[:2]),
            **{f"face_{n}": (face(n), face_draw(s))
               for n, s in tfd.CROP_SIZES.items()}}, face


def _det_state(module, opt):
    """Every parameter and buffer, and the Adam moments, as host copies."""
    out = {f"param {k}": v.detach().cpu().clone()
           for k, v in module.state_dict().items()}
    for kind in ("mu", "nu"):
        out.update({f"{kind} {k}": v.detach().cpu().clone()
                    for k, v in getattr(opt, kind).items()})
    return out


def _flagged(fn):
    """The messages torch.use_deterministic_algorithms(True, warn_only=
    True) raises as warnings while fn() runs (ops with no deterministic
    CUDA path, or cuBLAS without a fixed workspace)."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message)[:160] for w in caught
                   if "determinis" in str(w.message)
                   or "CUBLAS_WORKSPACE_CONFIG" in str(w.message)})


def check_ctc(seed=0):
    """The card CTC route (train/ctc.ctc_loss on a CUDA tensor: the
    forward-backward recursions) against its plain version on the card,
    on the OCR trainer's published batch: loss and d logits, two calls
    bit-equal, no op flagged."""
    from vcm_ts_tpu_torch import train_plate_ocr as tpo
    from vcm_ts_tpu_torch.eval.ocr_native import PlateOCRNative
    from vcm_ts_tpu_torch.train import ctc

    images, labels, pad, _ = tpo.make_batch(
        64, np.random.default_rng(seed), tpo.WIDTH_BUCKETS[-1])
    model = PlateOCRNative.init_random(0, "cuda").model
    with torch.no_grad():
        logits = model(torch.from_numpy(images).cuda()[:, None])

    def run(fn):
        x = logits.clone().requires_grad_(True)
        loss = fn(x, labels, pad)
        (gx,) = torch.autograd.grad(loss.sum(), x)
        return loss.detach(), gx

    (lc, gc), (lp, gp) = run(ctc.ctc_loss), run(ctc.ctc_loss_plain)
    out = {"shape": list(logits.shape),
           "loss_err": float((lc - lp).abs().max() / lp.abs().max()),
           "grad_err": float((gc - gp).abs().max() / gp.abs().max()),
           "repeat": bool(torch.equal(run(ctc.ctc_loss)[1], gc)),
           "card_ms": cuda_ms(lambda: run(ctc.ctc_loss), 5, 1),
           "plain_ms": cuda_ms(lambda: run(ctc.ctc_loss_plain), 3, 1),
           "flagged": _flagged(lambda: run(ctc.ctc_loss))}
    if not (out["loss_err"] <= CTC_TOL and out["grad_err"] <= CTC_TOL
            and out["repeat"] and not out["flagged"]):
        raise AssertionError(f"card CTC against its plain version: {out}")
    return out


def _det_frame(seed=5):
    """A 320x320 plate scene (uint8) and its plate boxes."""
    from vcm_ts_tpu_torch import train_plate_detector as tpd

    rng = np.random.default_rng(seed)
    for _ in range(20):
        img, boxes = tpd.compose_scene(rng)
        if len(boxes):
            return img.astype(np.uint8), boxes
    raise AssertionError("no plate scene with a plate in 20 draws")


def check_detector_exports(owners, root):
    """Export each trained model, load it back through the port's loaders
    (parameters bit-equal) and run it through the VCM adapters and the
    OCR on a synthesised frame."""
    from vcm_ts_tpu_torch import train_face_detector as tfd
    from vcm_ts_tpu_torch import train_plate_detector as tpd
    from vcm_ts_tpu_torch.eval.mtcnn_native import (MTCNNNativeDetector,
                                                    build_face_adapter)
    from vcm_ts_tpu_torch.eval.ocr_native import PlateOCRNative
    from vcm_ts_tpu_torch.eval.yolo_native import (YOLOv8NativeDetector,
                                                   build_lp_adapter)

    frame, boxes = _det_frame()
    paths = {k: os.path.join(root, k + ".npz")
             for k in ("plate_ocr", "yolov8-lp", "mtcnn")}
    owners["plate_ocr"].save(paths["plate_ocr"])
    tpd.export_npz(owners["plate_detector"], paths["yolov8-lp"])
    tfd.export_npz(owners["face"], paths["mtcnn"])
    loaded = {"plate_ocr": PlateOCRNative.load(paths["plate_ocr"],
                                               "cuda").model,
              "yolov8-lp": YOLOv8NativeDetector.load(paths["yolov8-lp"],
                                                     device="cuda"),
              "mtcnn": MTCNNNativeDetector.load(paths["mtcnn"], "cuda")}
    trained = {"plate_ocr": owners["plate_ocr"].model,
               "yolov8-lp": owners["plate_detector"],
               "mtcnn": owners["face"]}
    out = {}
    for k, model in trained.items():
        a, b = model.state_dict(), loaded[k].state_dict()
        out[k] = {"tensors": len(a), "differ": [
            n for n in a if not torch.equal(a[n].cpu(), b[n].cpu())]}
        if set(a) != set(b) or out[k]["differ"]:
            raise AssertionError(f"{k}: exported weights load back "
                                 f"otherwise: {out[k]}")
    lp_boxes, lp_scores = build_lp_adapter(paths["yolov8-lp"],
                                           device="cuda")(frame)
    face_boxes, face_scores = build_face_adapter(paths["mtcnn"],
                                                 "cuda")(frame)
    texts = PlateOCRNative.load(paths["plate_ocr"], "cuda")(
        frame.astype(np.float32) / 255.0, boxes)
    for name, (bx, sc) in (("lp", (lp_boxes, lp_scores)),
                           ("face", (face_boxes, face_scores))):
        if not (bx.shape[1:] == (4,) and len(bx) == len(sc)
                and np.isfinite(bx).all() and np.isfinite(sc).all()):
            raise AssertionError(f"{name} adapter output {bx.shape} "
                                 f"{sc.shape}")
    if len(texts) != len(boxes) or not all(
            isinstance(t, str) for t in texts):
        raise AssertionError(f"OCR on the exported weights: {texts}")
    out["adapters"] = {"lp_boxes": len(lp_boxes),
                       "face_boxes": len(face_boxes), "plates": len(boxes),
                       "texts": texts}
    for p in paths.values():
        out[os.path.basename(p) + "_bytes"] = os.path.getsize(p)
    return out


def run_detector_training(smi):
    """Phase 15: each trainer's step on the card at its published size:
    the overfit gate, the repeat gate, the determinism check, timings;
    the card CTC against its plain version; the export gate."""
    import tempfile

    from vcm_ts_tpu_torch.train.detector_steps import RunClock

    trainers, face = _det_trainers()
    face_det = None
    owners, rows = {}, {}
    for name, (fresh, draw) in trainers.items():
        build = fresh
        if name.startswith("face_"):
            # the face trainer's nets train in turn inside one detector
            build = face(name[len("face_"):], face_det)
        row = {}
        t = time.perf_counter()
        batch = draw(np.random.default_rng(1))
        row["synth_first_ms"] = (time.perf_counter() - t) * 1e3
        module, opt, step, owner = build()
        if name.startswith("face_"):
            face_det = owner
        losses = [float(step(*batch)) for _ in range(DET_STEPS)]
        row["loss_first"], row["loss_last"] = losses[0], losses[-1]
        if not (np.isfinite(losses).all()
                and losses[-1] < 0.5 * losses[0]):
            raise AssertionError(f"{name}: {DET_STEPS} steps on one batch "
                                 f"did not halve the loss: {losses}")
        owners[name] = owner
        # repeat gate: two steps from one state, the same batch
        states = []
        for _ in range(2):
            m2, o2, s2, _ = fresh()
            for _ in range(2):
                s2(*batch)
            torch.cuda.synchronize()
            states.append(_det_state(m2, o2))
        a, b = states
        row["repeat_tensors"] = len(a)
        row["repeat_differ"] = [k for k in a if not torch.equal(a[k], b[k])]
        if row["repeat_differ"]:
            raise AssertionError(f"{name}: two steps from one state differ "
                                 f"in {row['repeat_differ'][:6]}")
        s3 = fresh()[2]
        row["flagged"] = _flagged(lambda: s3(*batch))
        if row["flagged"]:
            raise AssertionError(f"{name}: torch.use_deterministic_"
                                 f"algorithms flags {row['flagged']}")
        # timed loop: a freshly drawn batch each step, as the trainer runs
        clock = RunClock(torch.device("cuda"))
        rng = np.random.default_rng(2)

        def loop():
            for _ in range(DET_LOOP):
                clock.synth_start()
                nb = draw(rng)
                clock.synth_end()
                clock.step(s3, *nb)

        prof = profile_ms(loop)
        row.update(clock.record())
        row.update(busy_ms_per_step=prof["device_busy_ms"] / DET_LOOP,
                   launches_per_step=prof["launches"] / DET_LOOP,
                   idle_share=prof["idle_share"],
                   top_kernels=prof["top_kernels"][:3])
        rows[name] = row
        say(f"[detector training] {name}: overfit {DET_STEPS} steps on one "
            f"batch {row['loss_first']:.4f} -> {row['loss_last']:.4f}; two "
            f"steps from one state bit-equal in all {row['repeat_tensors']} "
            f"tensors (parameters, buffers, Adam moments); "
            f"use_deterministic_algorithms flags none; over {DET_LOOP} "
            f"synthesise-and-step iterations under the profiler: step wall "
            f"{row['step_wall_ms']:.2f} ms (device busy "
            f"{row['busy_ms_per_step']:.2f} ms in "
            f"{row['launches_per_step']:.0f} launches, span "
            f"{row['step_span_ms']:.2f} ms), host synthesis "
            f"{row['synth_ms_per_batch']:.1f} ms a batch, device idle share "
            f"{row['idle_share']:.3f} ({smi})")
    owners["face"] = face_det
    ctc_row = check_ctc()
    say(f"[detector training] CTC on the card (the forward-backward "
        f"route) against its plain version at {ctc_row['shape']}: loss err "
        f"{ctc_row['loss_err']:.3g}, d logits err {ctc_row['grad_err']:.3g}"
        f" (of the largest; tol {CTC_TOL:g}); two calls bit-equal; flags "
        f"none; loss + backward {ctc_row['card_ms']:.3f} ms against the "
        f"plain recursion's {ctc_row['plain_ms']:.3f} ms ({smi})")
    with tempfile.TemporaryDirectory() as root:
        exports = check_detector_exports(owners, root)
    counts = ", ".join(f"{k} {exports[k]['tensors']} tensors"
                       for k in ("plate_ocr", "yolov8-lp", "mtcnn"))
    say(f"[detector training] exports load back bit-equal ({counts}); "
        f"on a 320x320 plate scene the LP adapter gave "
        f"{exports['adapters']['lp_boxes']} boxes, the face adapter "
        f"{exports['adapters']['face_boxes']}, the OCR "
        f"{exports['adapters']['texts']} for "
        f"{exports['adapters']['plates']} plates")
    return {"trainers": rows, "ctc": ctc_row, "exports": exports}


def _g3(xs):
    return "[" + ", ".join(f"{x:.3g}" for x in xs) + "]"


def say_rows(rows):
    """One [kernel] line per kernel row."""
    for r in rows:
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        extra = ("" if r["name"] != "warp_twopass" else
                 f" exact_warp_ms {r['exact_warp_ms']:.4f} grid_sample_ms "
                 f"{r['grid_sample_ms']:.4f} |flow|>D share "
                 f"{r['flow_beyond_d']:.2f}")
        if "per_frame" in r:
            extra += " launches per frame (P enc / P dec / I dec) " + \
                " / ".join(map(str, r["per_frame"]))
        if r["name"] == "warp_bwd":
            split = ("" if r["bucket_ms"] is None else
                     f" passes: bucket sort and plan {r['bucket_ms']:.4f} ms,"
                     f" accumulate (d flow + d im) "
                     f"{r['accumulate_ms']:.4f} ms;")
            extra += (f" (d flow err {r['err_dflow']:.3g} tol "
                      f"{r['tol_dflow']:.3g}; d im err {r['err_dim']:.3g} "
                      f"tol {r['tol_dim']:.3g}){split} the d flow pass alone "
                      f"{r['dflow_only_ms']:.4f} ms; two calls: same d flow "
                      f"and d im {r['dim_repeats']}")
        if r["name"] == "resize_bwd":
            extra += (f" two calls: same bits True; graph ms / aten's "
                      f"{r['ms'] / r['library_ms']:.2f}")
        if "b_bwd_dx_ms" in r:
            extra += (f" kernel B backward cuBLAS f32 dx "
                      f"{r['b_bwd_dx_ms']:.4f} ms dw {r['b_bwd_dw_ms']:.4f}"
                      " ms")
        lib_e = ("" if r["library_eager_ms"] is None
                 else f" (eager {r['library_eager_ms']:.4f})")
        eager = ("" if r["eager_ms"] is None
                 else f" (eager {r['eager_ms']:.4f})")
        plain = ("not timed" if r["plain_ms"] is None
                 else f"{r['plain_ms']:.4f}")
        say(f"[kernel] {r['name']} {r['shape']}: kernel_ms {r['ms']:.4f}"
            f"{eager} plain_ms {plain} "
            f"library_ms {lib}{lib_e} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) max_abs_err "
            f"{r['max_abs_err']:.3g} (tol {r['tol']:.3g}){extra}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "smoke_out"),
                    help="directory for chip_smoke.json and the .bin files")
    args = ap.parse_args()
    t_start = time.perf_counter()
    phase_s = {}
    t = t_start

    def phase_done(name):
        """Record and print the seconds since the last phase ended."""
        nonlocal t
        now = time.perf_counter()
        phase_s[name] = now - t
        say(f"[phase {name}] {phase_s[name]:.1f} s; total so far "
            f"{now - t_start:.1f} s")
        t = now
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
    t_build = time.perf_counter()
    cuda_build.build_all()
    say(f"[setup] kernels built in {time.perf_counter() - t_build:.1f} s")
    for name, log in cuda_build.build_log.items():
        for line in log.splitlines():
            if "registers" in line:
                say(f"[ptxas {name}] {line.strip()}")
    set_codec_numerics()
    phase_done("1 setup")

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = (check_warp(g) + check_subpel_conv1x1(g) + check_relayout(g)
            + check_warp_twopass(g))
    say_rows(rows)
    phase_done("2 kernels")

    intra, dmc = make_intra("cuda"), make_dmc("cuda")
    ref = small_reference(intra, dmc)
    say(f"[reference] 64x64 CPU vs GPU: {ref}")
    phase_done("3 reference")

    benches = []
    common = ["--size", f"{H}x{W}", "--frames", "3", "--warmup", "2",
              "--runs", "1", "--estimate-only"]
    for label, extra in (("bf16 fast-warp", ["--fast-warp"]),
                         ("bf16", []), ("f32", []), ("mixed", [])):
        b = run_bench(label, common + ["--dtype", label.split()[0], *extra])
        benches.append(b)
        say(f"[bench] {label}: {b['value']} fps (estimation, {W}x{H}), "
            f"launches {b['launches']} ({b['held_s']:.1f} s)")
    phase_done("4 bench")

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
        t_gop = time.perf_counter()
        gop = run_gop(*models, out_dir, tag, expect)
        gops.append(gop)
        say(f"[gop {tag}] I+{gop['frames'] - 1}P {W}x{H}: encode "
            f"{gop['encode_fps']:.3f} fps, decode {gop['decode_fps']:.3f} fps, "
            f"bin bytes {gop['bin_bytes']}, PSNR {gop['psnr_db']}, decoded == "
            f"encoder recon on every frame "
            f"({time.perf_counter() - t_gop:.1f} s)")
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

    phase_done("5 gops")
    batched = check_kernels_batched(g)
    say(f"[serving] kernels at N=2, each row == its N=1 launch bit for bit: "
        f"{', '.join(batched)} ({smi})")
    serving = run_serving(intra, dmc, intra16, dmc16, smi)
    phase_done("6 serving")

    vcm = run_vcm(out_dir, smi)
    say_vcm(vcm, time.perf_counter() - t, smi)
    vcm["intra_conv_launches"] = intra_conv_launches()
    for r in vcm["intra_conv_launches"]:
        say(f"[vcm] I-frame conv {r['conv']} input {r['input']} alone: "
            f"{r['launches']} launches, {r['device_ms']:.2f} ms device "
            f"({r['top_launches']} x {r['top_kernel']}; {smi})")

    phase_done("7 vcm")
    train_rows = (check_warp_bwd(g) + check_space_to_depth(g)
                  + check_resize_bwd(g))
    say_rows(train_rows)
    floor = launch_floor_ms()
    say(f"[kernel] launch floor: an empty kernel replayed from a CUDA "
        f"graph {floor['one_block_ms']:.4f} ms (1 block of 32 threads), "
        f"{floor['grid_512x256_ms']:.4f} ms (512 blocks of 256) ({smi})")
    say(f"[train] kernels A', C' and E' checked ({smi})")
    train = run_train(smi)
    rows += train_rows
    phase_done("8 train")

    evaluation = run_eval(out_dir, smi)
    say_eval(evaluation, smi)
    phase_done("9 eval")
    loop = run_trainloop(out_dir, smi)
    say_trainloop(loop, train["bench"][0]["value"], smi)
    phase_done("10 trainloop")
    perceptual = run_perceptual(out_dir, smi, train)
    phase_done("11 perceptual")
    parallel = run_parallel(out_dir, smi, evaluation)
    phase_done("12 parallel")
    tensor_parallel = run_tp(smi, g)
    rows += tensor_parallel["rows"]
    phase_done("13 tensor parallel")
    spatial = run_spatial(smi, g)
    rows += spatial["rows"]
    phase_done("14 spatial")
    detectors = run_detector_training(smi)
    phase_done("15 detector training")

    # one entry per kernel: its first (main-path) shape, and its launches
    # summed over the main paths: the two GOPs, the two batched serving
    # runs, the warm VCM pipeline run, one cascade train step, the eval
    # harness's sequential run, the trainer's run, one cascade step with
    # the perceptual loss, the trainer's perceptual run, and phases 12's,
    # 13's and 14's ranks (each read with the counts reset just before it)
    paths = gops + serving["batch"] + [vcm, train, evaluation, loop,
                                       perceptual["step"],
                                       perceptual["loop"], parallel,
                                       tensor_parallel, spatial]
    kernels = []
    for name in ("warp", "warp_bwd", "subpel_conv1x1",
                 "pixel_shuffle_relayout", "space_to_depth", "warp_twopass",
                 "resize_bwd"):
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
                   "kernels_batched": batched, "vcm": vcm,
                   "train": train, "eval": evaluation, "trainloop": loop,
                   "perceptual": perceptual, "parallel": parallel,
                   "tensor_parallel": {k: v for k, v in
                                       tensor_parallel.items()
                                       if k != "rows"},
                   "spatial": {k: v for k, v in spatial.items()
                               if k != "rows"},
                   "detector_training": detectors,
                   "launch_floor": floor,
                   "phase_s": phase_s, "kernels": kernels}, f,
                  indent=1, default=float)
    say(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s "
        f"({smi}); seconds by phase {json.dumps(phase_s)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
