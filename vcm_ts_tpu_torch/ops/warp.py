"""Backward warping (motion compensation): kernel A and its plain version.

Counterpart of vcm_ts_tpu/ops/warp.py. Bilinear sampling at (x + u, y + v)
with border clamping: the coordinates are computed in f32 and clamped to
the image BEFORE the floor, the taps are edge-padded, and the lerp is
((v00(1-wx) + v01 wx)(1-wy) + (v10(1-wx) + v11 wx) wy) in f32.

Tensors are NCHW with NHWC memory (`torch.channels_last`); the flow is
(N, 2, H, W), channel 0 horizontal. `flow_warp_packed` warps several
tensors that share one flow in one launch, without concatenating them.

Row window (spatial sharding, parallel/spatial.py): with `row0`, the flow
holds Hl rows, rows [row0, row0 + Hl) of a frame whose images hold all its
H rows, and the output is those Hl rows of the whole warp, bit for bit:
output row y samples at row0 + y + v, clamped to H - 1. row0 = 0 with
images as high as the flow is the whole warp. The window has no backward
(spatial sharding is inference only).

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch `csrc/warp.cu` (which rounds every op as the plain version does,
so the two agree bit for bit) or raise. The kernel reads an f32 or bf16
flow as it is; the coordinates are f32 in both versions.

Gradients: while autograd records and an input needs a gradient, the warp
runs as `_WarpFn`, whose backward is kernel A' (`csrc/warp_bwd.cu`) on the
card and `warp_backward_plain` on the CPU. Both follow XLA's autodiff of
the JAX gather exactly, including its clip rule: `jnp.clip` is
max-then-min, whose gradient is 0.5 where the coordinate equals a bound
(a zero flow at column 0 or W-1), where torch.clamp (and F.grid_sample)
would give 1. So the plain backward is written out with index_add_, not
taken from autograd through `warp_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

MAX_TENSORS = 4  # csrc/warp.cu kMaxTensors


def nhwc_dense(t: torch.Tensor) -> bool:
    """True when an NCHW tensor's memory is dense NHWC."""
    return t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)


def _clamped_coords(flow, h: int, row0: int):
    """Per pixel of the flow (rows row0.. of an image of h rows): the
    clamped tap (x0, y0) and weights."""
    _, _, hl, w = flow.shape
    f32, dev = torch.float32, flow.device
    ys = torch.arange(row0, row0 + hl, dtype=f32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=f32, device=dev)[None, None, :]
    px = torch.clamp(xs + flow[:, 0].float(), 0.0, w - 1.0)
    py = torch.clamp(ys + flow[:, 1].float(), 0.0, h - 1.0)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    return x0.long(), y0.long(), px - x0, py - y0


def warp_plain(ims, flow, row0: int = 0):
    """Plain PyTorch version: f32 coordinates and four gathers."""
    n, _, hl, w = flow.shape
    h = ims[0].shape[2]
    x0, y0, wx, wy = _clamped_coords(flow, h, row0)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    taps = [(yy * w + xx).reshape(n, hl * w)
            for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
    rows = torch.arange(n, device=flow.device)[:, None]
    wx = wx.reshape(n, hl * w, 1)
    wy = wy.reshape(n, hl * w, 1)
    outs = []
    for im in ims:
        c = im.shape[1]
        flat = im.permute(0, 2, 3, 1).reshape(n, h * w, c)
        v00, v01, v10, v11 = (flat[rows, q].float() for q in taps)
        out = ((v00 * (1.0 - wx) + v01 * wx) * (1.0 - wy)
               + (v10 * (1.0 - wx) + v11 * wx) * wy)
        outs.append(out.to(im.dtype).reshape(n, hl, w, c).permute(0, 3, 1,
                                                                   2))
    return outs


def check_window(ims, flow, row0: int) -> int:
    """The images' height H, after checking that the flow's rows are rows
    [row0, row0 + Hl) of images of one size (N, *, H, W)."""
    n, _, hl, w = flow.shape
    h = ims[0].shape[2]
    for im in ims:
        if im.dim() != 4 or im.shape[0] != n or im.shape[2:] != (h, w):
            raise ValueError(f"warp input {tuple(im.shape)} does not match "
                             f"the flow {tuple(flow.shape)} and the first "
                             f"input {tuple(ims[0].shape)}")
    if row0 < 0 or row0 + hl > h:
        raise ValueError(f"flow rows [{row0}, {row0 + hl}) are not rows of "
                         f"images of {h} rows")
    return h


def warp_cuda(ims, flow, row0: int = 0):
    """Launch kernel A on CUDA tensors (all NHWC-dense, one dtype): rows
    [row0, row0 + Hl) of the warp, Hl the flow's rows."""
    n, two, hl, w = flow.shape
    if two != 2 or not nhwc_dense(flow):
        raise ValueError("flow must be (N, 2, H, W) with NHWC memory")
    if not 1 <= len(ims) <= MAX_TENSORS:
        raise ValueError(f"warp takes 1..{MAX_TENSORS} tensors, got "
                         f"{len(ims)}")
    h = check_window(ims, flow, row0)
    dtype = ims[0].dtype
    for im in ims:
        if im.device != flow.device or im.dtype != dtype:
            raise ValueError("warp tensors must share the flow's device and "
                             "one dtype")
        if not nhwc_dense(im):
            raise ValueError(f"warp input {tuple(im.shape)} / strides "
                             f"{im.stride()} is not NHWC-dense")
    code = cuda_build.dtype_code(ims[0])
    # the kernel reads an f32 or bf16 flow and widens it in registers
    if flow.dtype not in (torch.float32, torch.bfloat16):
        flow = flow.float()
    outs = [torch.empty((n, im.shape[1], hl, w), dtype=dtype,
                        device=im.device, memory_format=torch.channels_last)
            for im in ims]
    k = len(ims)
    src = (ctypes.c_void_p * k)(*[im.data_ptr() for im in ims])
    dst = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])
    chans = (ctypes.c_int * k)(*[im.shape[1] for im in ims])
    rc = cuda_build.launcher("warp")(src, dst, chans, k, flow.data_ptr(),
                                     n, h, w, hl, row0, code,
                                     cuda_build.dtype_code(flow),
                                     cuda_build.stream_ptr(flow))
    cuda_build.check(rc, "warp")
    cuda_build.count_launch("warp")
    return outs


def _clip_grad(v, hi: float):
    """d clip(v, 0, hi) / dv as jnp.clip = minimum(maximum(v, 0), hi) gives
    it: 1 inside, 0 outside, 0.5 from each bound that v equals."""
    one, half, zero = (torch.full((), c, device=v.device) for c in
                       (1.0, 0.5, 0.0))
    lo = torch.where(v > 0, one, torch.where(v == 0, half, zero))
    u = torch.clamp_min(v, 0.0)
    return lo * torch.where(u < hi, one, torch.where(u == hi, half, zero))


def warp_backward_plain(ims, flow, grads, need_im: bool = True):
    """Plain version of kernel A': the warp's vector-Jacobian product.

    grads[j] is the gradient of warp output j. Returns (d flow in the
    flow's dtype, [d im_j in im_j's dtype, or None when not need_im]).
    d im scatter-adds g times the four tap weights into the four taps
    (f32 sums, cast once); d flow is g . d out / d(px, py) summed over
    every channel of every tensor, times the clip's gradient (_clip_grad);
    floor passes none. At x0 == W-1 the right tap is the edge pixel itself,
    so its difference, and its share of d flow, is 0."""
    n, _, h, w = flow.shape
    f32, dev = torch.float32, flow.device
    ys = torch.arange(h, dtype=f32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=f32, device=dev)[None, None, :]
    vx = xs + flow[:, 0].float()
    vy = ys + flow[:, 1].float()
    px = torch.clamp(vx, 0.0, w - 1.0)
    py = torch.clamp(vy, 0.0, h - 1.0)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = (px - x0).reshape(-1, 1)
    wy = (py - y0).reshape(-1, 1)
    x0, y0 = x0.long(), y0.long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    base = (torch.arange(n, device=dev) * (h * w))[:, None, None]
    taps = [(base + yy * w + xx).reshape(-1)
            for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
    ox, oy = 1.0 - wx, 1.0 - wy
    dwx = torch.zeros(n * h * w, dtype=f32, device=dev)
    dwy = torch.zeros(n * h * w, dtype=f32, device=dev)
    dims = []
    for im, g in zip(ims, grads):
        c = im.shape[1]
        flat = im.permute(0, 2, 3, 1).reshape(-1, c)
        v00, v01, v10, v11 = (flat[q].float() for q in taps)
        gf = g.permute(0, 2, 3, 1).reshape(-1, c).float()
        dtop = gf * oy
        dbot = gf * wy
        top = v00 * ox + v01 * wx
        bot = v10 * ox + v11 * wx
        dwx += (dtop * (v01 - v00) + dbot * (v11 - v10)).sum(1)
        dwy += (gf * (bot - top)).sum(1)
        if not need_im:
            dims.append(None)
            continue
        d = torch.zeros((n * h * w, c), dtype=f32, device=dev)
        for q, part in zip(taps, (dtop * ox, dtop * wx, dbot * ox,
                                  dbot * wx)):
            d.index_add_(0, q, part)
        dims.append(d.to(im.dtype).reshape(n, h, w, c).permute(0, 3, 1, 2))
    dflow = torch.stack((dwx.reshape(n, h, w) * _clip_grad(vx, w - 1.0),
                         dwy.reshape(n, h, w) * _clip_grad(vy, h - 1.0)),
                        dim=-1).to(flow.dtype)
    return dflow.permute(0, 3, 1, 2), dims


def warp_backward_cuda(ims, flow, grads, need_im: bool = True):
    """Launch kernel A' on CUDA tensors (checks as warp_cuda; each grads[j]
    shaped and typed as ims[j]). d im accumulates in f32 buffers through
    atomics, in an order that changes from run to run, and is cast once to
    the data's dtype; d flow is summed in a fixed order."""
    n, two, h, w = flow.shape
    if two != 2 or not nhwc_dense(flow):
        raise ValueError("flow must be (N, 2, H, W) with NHWC memory")
    if not 1 <= len(ims) <= MAX_TENSORS or len(grads) != len(ims):
        raise ValueError(f"warp backward takes 1..{MAX_TENSORS} tensors and "
                         "one gradient each")
    dtype = ims[0].dtype
    for im, g in zip(ims, grads):
        for t in (im, g):
            if t.device != flow.device or t.dtype != dtype:
                raise ValueError("warp backward tensors must share the "
                                 "flow's device and one dtype")
            if (t.shape != im.shape or t.shape[0] != n
                    or t.shape[2:] != (h, w) or not nhwc_dense(t)):
                raise ValueError(f"warp backward tensor {tuple(t.shape)} / "
                                 f"strides {t.stride()} is not NHWC-dense at "
                                 "the flow's size")
    code = cuda_build.dtype_code(ims[0])
    if flow.dtype not in (torch.float32, torch.bfloat16):
        flow = flow.float()
    k = len(ims)
    dims = [torch.zeros_like(im, dtype=torch.float32,
                             memory_format=torch.channels_last)
            if need_im else None for im in ims]
    dflow = torch.empty_like(flow, memory_format=torch.channels_last)
    src = (ctypes.c_void_p * k)(*[im.data_ptr() for im in ims])
    grd = (ctypes.c_void_p * k)(*[g.data_ptr() for g in grads])
    dst = (ctypes.c_void_p * k)(*[d.data_ptr() if need_im else 0
                                  for d in dims])
    chans = (ctypes.c_int * k)(*[im.shape[1] for im in ims])
    rc = cuda_build.launcher("warp_bwd")(
        src, grd, dst, chans, k, flow.data_ptr(), dflow.data_ptr(), n, h, w,
        code, cuda_build.dtype_code(flow), int(need_im),
        cuda_build.stream_ptr(flow))
    cuda_build.check(rc, "warp_bwd")
    cuda_build.count_launch("warp_bwd")
    if need_im and dtype != torch.float32:
        dims = [d.to(dtype) for d in dims]
    return dflow, dims


def _forward(ims, flow, row0: int = 0):
    if flow.device.type == "cpu":
        check_window(ims, flow, row0)
        return warp_plain(ims, flow, row0)
    if flow.device.type == "cuda":
        return warp_cuda(ims, flow, row0)
    raise ValueError(f"warp has no version for device {flow.device}")


class _WarpFn(torch.autograd.Function):
    """The warp of `ims` by `flow` with kernel A' as its backward."""

    @staticmethod
    def forward(ctx, flow, *ims):
        ctx.save_for_backward(flow, *ims)
        return tuple(_forward(list(ims), flow))

    @staticmethod
    def backward(ctx, *grads):
        flow, *ims = ctx.saved_tensors
        need_im = any(ctx.needs_input_grad[1:])
        if flow.device.type == "cuda":
            grads = [g.contiguous(memory_format=torch.channels_last)
                     for g in grads]
            dflow, dims = warp_backward_cuda(ims, flow, grads, need_im)
        elif flow.device.type == "cpu":
            dflow, dims = warp_backward_plain(ims, flow, grads, need_im)
        else:
            raise ValueError(f"warp has no backward for device {flow.device}")
        dflow = dflow if ctx.needs_input_grad[0] else None
        return (dflow, *[d if need else None for d, need in
                         zip(dims, ctx.needs_input_grad[1:])])


def _dispatch(ims, flow, row0: int = 0):
    if torch.is_grad_enabled() and (flow.requires_grad
                                    or any(im.requires_grad for im in ims)):
        if row0 or ims[0].shape[2] != flow.shape[2]:
            raise RuntimeError("the warp's row window has no backward "
                               "(spatial sharding is inference only)")
        return list(_WarpFn.apply(flow, *ims))
    return _forward(ims, flow, row0)


def flow_warp(im, flow, row0: int = 0):
    """Backward-warp `im` (N, C, H, W) by `flow` (N, 2, H, W); with a row
    window, flow (N, 2, Hl, W) and the output rows [row0, row0 + Hl)."""
    return _dispatch([im], flow, row0)[0]


def flow_warp_packed(ims, flow, row0: int = 0):
    """Backward-warp several same-size tensors by one flow, in one launch.
    Tensors of mixed dtypes are promoted to their common dtype first, as
    the JAX package's concatenation does; then the result is bit-identical
    to separate flow_warp calls. Returns a list. `row0`: as flow_warp."""
    dt = ims[0].dtype
    for im in ims[1:]:
        dt = torch.promote_types(dt, im.dtype)
    return _dispatch([im.to(dt) for im in ims], flow, row0)
