"""Sub-pixel convolution + pixel shuffle: kernels B and C, plain versions.

Counterpart of vcm_ts_tpu/ops/subpel_pallas.py. The conv's output channels
are permuted from torch's c-major order (o = c*r^2 + dy*r + dx) to k-major
order (o = (dy*r + dx)*C + c) once, on the weights; in k-major order the
depth-to-space is a copy of contiguous r*C channel segments.

- `pixel_shuffle_relayout` (kernel C, csrc/pixel_shuffle.cu): k-major
  depth-to-space after a cuDNN conv (the 3x3 SubpelConv sites).
- `subpel_conv1x1` (kernel B, csrc/subpel_conv1x1.cu): the 1x1 conv and
  the shuffle fused, so the pre-shuffle tensor is never written.
- `space_to_depth` (kernel C', csrc/space_to_depth.cu): the inverse
  permutation, k-major space-to-depth.

Both forwards carry the JAX package's custom VJPs (`_relayout_bwd`,
`_conv1x1_bwd`) as autograd Functions, taken while autograd records: C's
backward is C'; B's backward is C' (gk) followed by the products
dx = gk w^T, dw = x^T gk and db = sum gk in f32, cast to x's and w's
dtypes (plain torch ops, as the JAX package leaves them to XLA).

Tensors are NCHW with NHWC memory (`torch.channels_last`). On a CPU tensor
the wrappers run the plain versions; on a CUDA tensor they launch the
kernel or raise.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .rowwise import conv2d
from .warp import nhwc_dense


def permute_out_channels(w: torch.Tensor, r: int) -> torch.Tensor:
    """OIHW conv weights (or an (O,) bias), c-major -> k-major order along
    the output-channel axis."""
    o, *rest = w.shape
    c = o // (r * r)
    return w.reshape(c, r * r, *rest).transpose(0, 1).reshape(o, *rest)


def relayout_plain(x: torch.Tensor, r: int) -> torch.Tensor:
    """Plain version of kernel C: reshape/permute."""
    n, crr, h, w = x.shape
    c = crr // (r * r)
    y = x.reshape(n, r, r, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c, h * r, w * r).contiguous(
        memory_format=torch.channels_last)


def space_to_depth_plain(g: torch.Tensor, r: int) -> torch.Tensor:
    """Plain version of kernel C': (N, C, H*r, W*r) -> (N, r*r*C, H, W),
    k-major channels (the inverse of relayout_plain)."""
    n, c, hr, wr = g.shape
    h, w = hr // r, wr // r
    y = g.reshape(n, c, h, r, w, r).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, r * r * c, h, w).contiguous(
        memory_format=torch.channels_last)


def subpel_conv1x1_plain(x, w_kmajor, b_kmajor, r: int):
    """Plain version of kernel B: a 1x1 conv (ops/rowwise.py), then the
    shuffle."""
    rr, cin, c = w_kmajor.shape
    w = w_kmajor.permute(0, 2, 1).reshape(rr * c, cin, 1, 1)
    return relayout_plain(conv2d(x, w, b_kmajor.reshape(rr * c)), r)


def _out_like(x, c, r):
    n, _, h, w = x.shape
    return torch.empty((n, c, h * r, w * r), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


def relayout_cuda(x: torch.Tensor, r: int) -> torch.Tensor:
    n, crr, h, w = x.shape
    if crr % (r * r) or not nhwc_dense(x):
        raise ValueError(f"relayout input {tuple(x.shape)} / strides "
                         f"{x.stride()}: need r*r*C channels, NHWC memory")
    cuda_build.dtype_code(x)
    c = crr // (r * r)
    out = _out_like(x, c, r)
    rc = cuda_build.launcher("pixel_shuffle")(
        x.data_ptr(), out.data_ptr(), n, h, w, c, r, x.element_size(),
        cuda_build.stream_ptr(x))
    cuda_build.check(rc, "pixel_shuffle_relayout")
    cuda_build.count_launch("pixel_shuffle_relayout")
    return out


def space_to_depth_cuda(g: torch.Tensor, r: int) -> torch.Tensor:
    n, c, hr, wr = g.shape
    if hr % r or wr % r or not nhwc_dense(g):
        raise ValueError(f"space_to_depth input {tuple(g.shape)} / strides "
                         f"{g.stride()}: need H, W divisible by {r}, NHWC "
                         "memory")
    cuda_build.dtype_code(g)
    h, w = hr // r, wr // r
    out = torch.empty((n, r * r * c, h, w), dtype=g.dtype, device=g.device,
                      memory_format=torch.channels_last)
    rc = cuda_build.launcher("space_to_depth")(
        g.data_ptr(), out.data_ptr(), n, h, w, c, r, g.element_size(),
        cuda_build.stream_ptr(g))
    cuda_build.check(rc, "space_to_depth")
    cuda_build.count_launch("space_to_depth")
    return out


def subpel_conv1x1_cuda(x, w_kmajor, b_kmajor, r: int):
    n, cin, h, w = x.shape
    rr, cin_w, c = w_kmajor.shape
    if rr != r * r or cin_w != cin or tuple(b_kmajor.shape) != (rr, c):
        raise ValueError(f"subpel_conv1x1: x {tuple(x.shape)}, w "
                         f"{tuple(w_kmajor.shape)}, b {tuple(b_kmajor.shape)}"
                         f" do not fit r={r}")
    if not nhwc_dense(x) or not (w_kmajor.is_contiguous()
                                 and b_kmajor.is_contiguous()):
        raise ValueError("subpel_conv1x1 needs NHWC-dense x and contiguous "
                         "weights")
    if not (x.dtype == w_kmajor.dtype == b_kmajor.dtype) or not (
            x.device == w_kmajor.device == b_kmajor.device):
        raise ValueError("subpel_conv1x1 operands must share dtype and device")
    code = cuda_build.dtype_code(x)
    out = _out_like(x, c, r)
    rc = cuda_build.launcher("subpel_conv1x1")(
        x.data_ptr(), w_kmajor.data_ptr(), b_kmajor.data_ptr(), out.data_ptr(),
        n, h, w, cin, c, r, code, cuda_build.stream_ptr(x))
    cuda_build.check(rc, "subpel_conv1x1")
    cuda_build.count_launch("subpel_conv1x1")
    return out


def _relayout(x, r):
    if x.device.type == "cpu":
        return relayout_plain(x, r)
    if x.device.type == "cuda":
        return relayout_cuda(x, r)
    raise ValueError(f"pixel_shuffle_relayout has no version for {x.device}")


def _conv1x1(x, w_kmajor, b_kmajor, r):
    if x.device.type == "cpu":
        return subpel_conv1x1_plain(x, w_kmajor, b_kmajor, r)
    if x.device.type == "cuda":
        return subpel_conv1x1_cuda(x, w_kmajor, b_kmajor, r)
    raise ValueError(f"subpel_conv1x1 has no version for {x.device}")


def space_to_depth(g: torch.Tensor, r: int = 2) -> torch.Tensor:
    """k-major space-to-depth (N, C, H*r, W*r) -> (N, r*r*C, H, W): the
    inverse of pixel_shuffle_relayout."""
    if g.device.type == "cpu":
        return space_to_depth_plain(g, r)
    if g.device.type == "cuda":
        return space_to_depth_cuda(g, r)
    raise ValueError(f"space_to_depth has no version for {g.device}")


def _nhwc(t):
    return t.contiguous(memory_format=torch.channels_last)


class _RelayoutFn(torch.autograd.Function):
    """Kernel C with C' as its backward (_relayout_vjp)."""

    @staticmethod
    def forward(ctx, x, r):
        ctx.r = r
        return _relayout(x, r)

    @staticmethod
    def backward(ctx, g):
        return space_to_depth(_nhwc(g), ctx.r), None


class _Conv1x1Fn(torch.autograd.Function):
    """Kernel B with _conv1x1_bwd as its backward: C' makes gk, then
    three products summed in f32."""

    @staticmethod
    def forward(ctx, x, w_kmajor, b_kmajor, r):
        ctx.r = r
        ctx.b_dtype = b_kmajor.dtype
        ctx.save_for_backward(x, w_kmajor)
        return _conv1x1(x, w_kmajor, b_kmajor, r)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        rr, cin, c = w.shape
        n, _, h, wd = x.shape
        gk = space_to_depth(_nhwc(g), ctx.r)
        gk2 = gk.permute(0, 2, 3, 1).reshape(-1, rr * c).float()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            wt = w.permute(0, 2, 1).reshape(rr * c, cin).float()
            dx = (gk2 @ wt).to(x.dtype).reshape(n, h, wd, cin).permute(
                0, 3, 1, 2)
        if ctx.needs_input_grad[1]:
            x2 = x.permute(0, 2, 3, 1).reshape(-1, cin).float()
            dw = (x2.t() @ gk2).reshape(cin, rr, c).permute(1, 0, 2).to(
                w.dtype)
        if ctx.needs_input_grad[2]:
            db = gk2.sum(0).reshape(rr, c).to(ctx.b_dtype)
        return dx, dw, db, None


def _records(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def pixel_shuffle_relayout(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Depth-to-space of k-major (N, r*r*C, H, W) -> (N, C, H*r, W*r);
    equals torch's pixel_shuffle of the equivalent c-major tensor."""
    if _records(x):
        return _RelayoutFn.apply(x, r)
    return _relayout(x, r)


def subpel_conv1x1(x, w_kmajor, b_kmajor, r: int = 2):
    """pixel_shuffle(conv1x1(x, w, b), r) in torch channel order, from k-major
    weights (r*r, Cin, C) and bias (r*r, C); f32 accumulation."""
    if _records(x, w_kmajor, b_kmajor):
        return _Conv1x1Fn.apply(x, w_kmajor, b_kmajor, r)
    return _conv1x1(x, w_kmajor, b_kmajor, r)
