"""Resampling ops on NCHW tensors with the JAX package's semantics.

Counterpart of vcm_ts_tpu/ops/resize.py: `jax.image.resize(..., "bilinear",
antialias=False)` is torch's half-pixel bilinear interpolation
(align_corners=False) for the exact 2x factors used here.

Gradients: while autograd records and the input needs a gradient, the
bilinear resize runs as `_BilinearFn`. Its forward is F.interpolate (on
the card too: deterministic); its backward is kernel E'
(`csrc/resize_bwd.cu`) on a CUDA tensor and `resize_backward_plain` on
the CPU. Both compute JAX's VJP, the transposed weight-matrix einsum
d x = Ry^T . g . Rx, in a fixed order, where PyTorch's CUDA backward adds
with atomics and does not repeat bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build


def _interpolate(x, size):
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=False)


def resize_weights(n_in: int, n_out: int, device=None,
                   dtype=torch.float32):
    """(n_out, n_in) matrix R of one axis: out = R . in, in `dtype` (f32,
    or float64 for float64 data). Row o holds PyTorch's two taps
    (area_pixel_compute_source_index, align_corners False): s = max(scale
    (o + 0.5) - 0.5, 0) with scale = in / out in that dtype, i0 = floor(s),
    i1 = min(i0 + 1, in - 1), weights 1 - (s - i0) and s - i0, added where
    i0 == i1."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    # built from device ops alone (no copy from the host), so that a CUDA
    # graph can capture it
    scale = torch.full((), float(np_dt(n_in) / np_dt(n_out)), dtype=dtype,
                       device=device)
    o = torch.arange(n_out, dtype=dtype, device=device)
    s = torch.clamp_min(scale * (o + 0.5) - 0.5, 0.0)
    i0 = s.long()[:, None]
    i1 = torch.where(i0 < n_in - 1, i0 + 1, i0)
    l1 = (s[:, None] - i0.to(dtype))
    zero = torch.zeros((), dtype=dtype, device=device)
    i = torch.arange(n_in, device=device)[None, :]
    return (torch.where(i == i0, 1.0 - l1, zero)
            + torch.where(i == i1, l1, zero))


def resize_backward_plain(g, h: int, w: int):
    """Plain version of kernel E': d x (N, C, h, w) of the bilinear resize
    whose output gradient is g, as JAX's VJP computes it: Ry^T . (g . Rx),
    the taps' weights those of g's dtype's forward (f32, or float64 for
    float64 g), the sums in float64, rounded once to g's dtype. One product
    of fixed size per plane (bmm), so a row's bits do not follow the batch
    size (a matmul over the folded batch would)."""
    n, c, ho, wo = g.shape
    dt = torch.float64 if g.dtype == torch.float64 else torch.float32
    ry = resize_weights(h, ho, g.device, dt).double()
    rx = resize_weights(w, wo, g.device, dt).double()
    planes = g.double().reshape(n * c, ho, wo)
    t = torch.bmm(planes, rx.expand(n * c, wo, w))
    dx = torch.bmm(ry.t().expand(n * c, h, ho), t)
    return dx.reshape(n, c, h, w).to(g.dtype)


_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def resize_backward_cuda(g, h: int, w: int):
    """Launch kernel E' on a CUDA tensor g (N, C, Ho, Wo), f32, bf16 or
    float64: d x (N, C, h, w), NHWC-dense, in g's dtype; each element a sum
    in a fixed order, so two calls give the same bits."""
    n, c, ho, wo = g.shape
    if g.dtype not in _CODES:
        raise TypeError(f"resize backward takes float32, bfloat16 or "
                        f"float64, got {g.dtype}")
    code = _CODES[g.dtype]
    g = g.contiguous(memory_format=torch.channels_last)
    dx = torch.empty((n, c, h, w), dtype=g.dtype, device=g.device,
                     memory_format=torch.channels_last)
    rc = cuda_build.launcher("resize_bwd")(
        g.data_ptr(), dx.data_ptr(), n, c, h, w, ho, wo, code,
        cuda_build.stream_ptr(g))
    cuda_build.check(rc, "resize_bwd")
    cuda_build.count_launch("resize_bwd")
    return dx


class _BilinearFn(torch.autograd.Function):
    """F.interpolate's bilinear resize with kernel E' as its backward."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.in_hw = tuple(x.shape[2:])
        ctx.nhwc = x.is_contiguous(memory_format=torch.channels_last)
        return _interpolate(x, size)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.in_hw
        if g.device.type == "cuda":
            dx = resize_backward_cuda(g, h, w)
        elif g.device.type == "cpu":
            dx = resize_backward_plain(g, h, w)
        else:
            raise ValueError(f"resize has no backward for device {g.device}")
        fmt = (torch.channels_last if ctx.nhwc
               else torch.contiguous_format)
        return dx.contiguous(memory_format=fmt), None


def bilinear_resize(x, size):
    """Bilinear resize of x (N, C, H, W) to `size` (h, w), half-pixel
    centers, no antialias (jax.image.resize's "bilinear")."""
    size = (int(size[0]), int(size[1]))
    if torch.is_grad_enabled() and x.requires_grad:
        return _BilinearFn.apply(x, size)
    return _interpolate(x, size)


def bilinear_up2(x):
    """2x bilinear upsampling, half-pixel centers."""
    _, _, h, w = x.shape
    return bilinear_resize(x, (h * 2, w * 2))


def bilinear_down2(x):
    """0.5x bilinear downsampling, half-pixel centers, no antialias."""
    _, _, h, w = x.shape
    return bilinear_resize(x, (h // 2, w // 2))


def avg_pool2(x):
    """2x2 average pooling with stride 2."""
    return F.avg_pool2d(x, 2)


def max_pool2(x):
    """2x2 max pooling with stride 2 (UNet downsampling)."""
    return F.max_pool2d(x, 2)
