"""Backward warping (motion compensation): kernel A and its plain version.

Counterpart of vcm_ts_tpu/ops/warp.py. Bilinear sampling at (x + u, y + v)
with border clamping: the coordinates are computed in f32 and clamped to
the image BEFORE the floor, the taps are edge-padded, and the lerp is
((v00(1-wx) + v01 wx)(1-wy) + (v10(1-wx) + v11 wx) wy) in f32.

Tensors are NCHW with NHWC memory (`torch.channels_last`); the flow is
(N, 2, H, W), channel 0 horizontal. `flow_warp_packed` warps several
tensors that share one flow in one launch, without concatenating them.

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch `csrc/warp.cu` (which rounds every op as the plain version does,
so the two agree bit for bit) or raise. The kernel reads an f32 or bf16
flow as it is; the coordinates are f32 in both versions.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

MAX_TENSORS = 4  # csrc/warp.cu kMaxTensors


def nhwc_dense(t: torch.Tensor) -> bool:
    """True when an NCHW tensor's memory is dense NHWC."""
    return t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)


def _clamped_coords(flow):
    _, _, h, w = flow.shape
    f32, dev = torch.float32, flow.device
    ys = torch.arange(h, dtype=f32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=f32, device=dev)[None, None, :]
    px = torch.clamp(xs + flow[:, 0].float(), 0.0, w - 1.0)
    py = torch.clamp(ys + flow[:, 1].float(), 0.0, h - 1.0)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    return x0.long(), y0.long(), px - x0, py - y0


def warp_plain(ims, flow):
    """Plain PyTorch version: f32 coordinates and four gathers."""
    n, _, h, w = flow.shape
    x0, y0, wx, wy = _clamped_coords(flow)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    taps = [(yy * w + xx).reshape(n, h * w)
            for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
    rows = torch.arange(n, device=flow.device)[:, None]
    wx = wx.reshape(n, h * w, 1)
    wy = wy.reshape(n, h * w, 1)
    outs = []
    for im in ims:
        c = im.shape[1]
        flat = im.permute(0, 2, 3, 1).reshape(n, h * w, c)
        v00, v01, v10, v11 = (flat[rows, q].float() for q in taps)
        out = ((v00 * (1.0 - wx) + v01 * wx) * (1.0 - wy)
               + (v10 * (1.0 - wx) + v11 * wx) * wy)
        outs.append(out.to(im.dtype).reshape(n, h, w, c).permute(0, 3, 1, 2))
    return outs


def warp_cuda(ims, flow):
    """Launch kernel A on CUDA tensors (all NHWC-dense, one dtype)."""
    n, two, h, w = flow.shape
    if two != 2 or not nhwc_dense(flow):
        raise ValueError("flow must be (N, 2, H, W) with NHWC memory")
    if not 1 <= len(ims) <= MAX_TENSORS:
        raise ValueError(f"warp takes 1..{MAX_TENSORS} tensors, got "
                         f"{len(ims)}")
    dtype = ims[0].dtype
    for im in ims:
        if im.device != flow.device or im.dtype != dtype:
            raise ValueError("warp tensors must share the flow's device and "
                             "one dtype")
        if im.shape[0] != n or im.shape[2:] != (h, w) or not nhwc_dense(im):
            raise ValueError(f"warp input {tuple(im.shape)} / strides "
                             f"{im.stride()} is not NHWC-dense at the flow's "
                             "size")
    code = cuda_build.dtype_code(ims[0])
    # the kernel reads an f32 or bf16 flow and widens it in registers
    if flow.dtype not in (torch.float32, torch.bfloat16):
        flow = flow.float()
    outs = [torch.empty_like(im, memory_format=torch.channels_last)
            for im in ims]
    k = len(ims)
    src = (ctypes.c_void_p * k)(*[im.data_ptr() for im in ims])
    dst = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])
    chans = (ctypes.c_int * k)(*[im.shape[1] for im in ims])
    rc = cuda_build.launcher("warp")(src, dst, chans, k, flow.data_ptr(),
                                     n, h, w, code,
                                     cuda_build.dtype_code(flow),
                                     cuda_build.stream_ptr(flow))
    cuda_build.check(rc, "warp")
    cuda_build.count_launch("warp")
    return outs


def _dispatch(ims, flow):
    if flow.device.type == "cpu":
        return warp_plain(ims, flow)
    if flow.device.type == "cuda":
        return warp_cuda(ims, flow)
    raise ValueError(f"warp has no version for device {flow.device}")


def flow_warp(im, flow):
    """Backward-warp `im` (N, C, H, W) by `flow` (N, 2, H, W)."""
    return _dispatch([im], flow)[0]


def flow_warp_packed(ims, flow):
    """Backward-warp several same-size tensors by one flow, in one launch.
    Tensors of mixed dtypes are promoted to their common dtype first, as
    the JAX package's concatenation does; then the result is bit-identical
    to separate flow_warp calls. Returns a list."""
    dt = ims[0].dtype
    for im in ims[1:]:
        dt = torch.promote_types(dt, im.dtype)
    return _dispatch([im.to(dt) for im in ims], flow)
