"""Two-pass separable warp with a displacement bound: kernel D, plain version.

Counterpart of vcm_ts_tpu/ops/warp_pallas.py (`flow_warp_pallas`), the
DMC's opt-in `fast_warp`. For output pixel (y, x), all in f32 whatever the
data type: the horizontal lerp uses this pixel's flow, clamped to the image
before the floor, with its integer shift dx clamped to [-D, D]; the two
columns it blends, xa = x + dx and xa + 1, are each first lerped
vertically with the flow AT THAT COLUMN (shift dy clamped to [-D, D]).
Both lerps are written a + w (b - a), not the exact warp's (1-w) a + w b.
It equals ops/warp.flow_warp only for flows constant along x, and failed
the JAX package's quality gate as a default (tests/test_warp_pallas.py),
so it stays opt-in. The TPU tiling parameters (block_h, block_c) have no
effect on the result and are not carried over.

Row window (spatial sharding), as ops/warp.py's: with `row0` the flow
holds rows [row0, row0 + Hl) of a frame whose image holds all its H rows,
y above is the image row, and the output is those rows of the whole warp,
bit for bit.

Tensors are NCHW with NHWC memory (`torch.channels_last`); the flow is
(N, 2, H, W), channel 0 horizontal, as in ops/warp.py. On a CPU tensor
`flow_warp_twopass` runs the plain version; on a CUDA tensor it launches
`csrc/warp_twopass.cu` (which rounds every op as the plain version does,
so the two agree bit for bit) or raises. It has no backward: the JAX
package gives kernel D no VJP, and training runs the exact warp, so a
warp that would record a gradient raises.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .warp import check_window, nhwc_dense


def _taps(flow, max_disp: int, h: int, row0: int):
    """Per output pixel (rows row0.. of an image of h rows): flat tap
    indices (row r, row r+1) x (column xa, column xb) into the image and
    the weights (wy at xa, wy at xb, wx), all (N, Hl*W)."""
    n, _, hl, w = flow.shape
    f32, dev = torch.float32, flow.device
    d = float(max_disp)
    fx = flow[:, 0].float()
    fy = flow[:, 1].float()
    gy = torch.arange(row0, row0 + hl, dtype=f32, device=dev)[None, :, None]
    gx = torch.arange(w, dtype=f32, device=dev)[None, None, :]
    px = torch.clamp(gx + fx, 0.0, w - 1.0)
    x0 = torch.floor(px)
    xa = (gx + torch.clamp(x0 - gx, -d, d)).long()
    # xb = w and row r+1 = h occur only under a zero weight: clamped, the
    # tap's value never reaches the result
    xb = torch.clamp(xa + 1, max=w - 1)
    idx, wts = [], []
    for col in (xa, xb):
        py = torch.clamp(gy + torch.gather(fy, 2, col), 0.0, h - 1.0)
        y0 = torch.floor(py)
        r = (gy + torch.clamp(y0 - gy, -d, d)).long()
        idx += [r * w + col, torch.clamp(r + 1, max=h - 1) * w + col]
        wts.append(py - y0)
    wts.append(px - x0)
    return ([q.reshape(n, hl * w) for q in idx],
            [v.reshape(n, hl * w, 1) for v in wts])


def warp_twopass_plain(im, flow, max_disp: int, row0: int = 0):
    """Plain PyTorch version: f32 coordinates and four gathers."""
    n, c, h, w = im.shape
    hl = flow.shape[2]
    (qa0, qa1, qb0, qb1), (wya, wyb, wx) = _taps(flow, max_disp, h, row0)
    rows = torch.arange(n, device=im.device)[:, None]
    flat = im.permute(0, 2, 3, 1).reshape(n, h * w, c)
    a0, a1, b0, b1 = (flat[rows, q].float() for q in (qa0, qa1, qb0, qb1))
    va = a0 + wya * (a1 - a0)
    vb = b0 + wyb * (b1 - b0)
    out = va + wx * (vb - va)
    return out.to(im.dtype).reshape(n, hl, w, c).permute(0, 3, 1, 2)


def warp_twopass_cuda(im, flow, max_disp: int, row0: int = 0):
    """Launch kernel D on CUDA tensors (NHWC-dense, f32 or bf16): rows
    [row0, row0 + Hl) of the warp, Hl the flow's rows."""
    n, c, h, w = im.shape
    hl = flow.shape[2]
    if flow.shape[:2] != (n, 2) or not nhwc_dense(flow):
        raise ValueError(f"flow {tuple(flow.shape)} must be (N, 2, H, W) "
                         "with NHWC memory")
    check_window([im], flow, row0)
    if not nhwc_dense(im) or im.device != flow.device:
        raise ValueError(f"warp_twopass input {tuple(im.shape)} / strides "
                         f"{im.stride()} is not NHWC-dense on the flow's "
                         "device")
    if max_disp < 0:
        raise ValueError(f"max_disp must be >= 0, got {max_disp}")
    code = cuda_build.dtype_code(im)
    flow32 = flow.float()  # coordinates are f32 whatever the data type
    out = torch.empty((n, c, hl, w), dtype=im.dtype, device=im.device,
                      memory_format=torch.channels_last)
    rc = cuda_build.launcher("warp_twopass")(
        im.data_ptr(), out.data_ptr(), c, flow32.data_ptr(), n, h, w, hl,
        row0, max_disp, code, cuda_build.stream_ptr(flow32))
    cuda_build.check(rc, "warp_twopass")
    cuda_build.count_launch("warp_twopass")
    return out


def flow_warp_twopass(im, flow, max_disp: int, row0: int = 0):
    """Two-pass backward warp of `im` (N, C, H, W) by `flow` (N, 2, H, W),
    each shift bounded by `max_disp` pixels; with a row window, flow
    (N, 2, Hl, W) and the output rows [row0, row0 + Hl)."""
    if torch.is_grad_enabled() and (im.requires_grad or flow.requires_grad):
        raise RuntimeError(
            "flow_warp_twopass (kernel D, fast_warp) has no backward: the "
            "JAX package defines no VJP for its _warp_kernel; train with "
            "fast_warp=False (the exact warp, kernels A and A')")
    if flow.device.type == "cpu":
        check_window([im], flow, row0)
        return warp_twopass_plain(im, flow, max_disp, row0)
    if flow.device.type == "cuda":
        return warp_twopass_cuda(im, flow, max_disp, row0)
    raise ValueError(f"warp_twopass has no version for device {flow.device}")
