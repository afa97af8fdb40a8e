"""Spatial sharding: one stream's frames split by rows (H) over ranks (the
port's counterpart of vcm_ts_tpu/parallel/spatial.py, behind the engines'
set_spatial_sharding).

The JAX package shards the H axis of every NHWC plane over a "spatial"
mesh axis and lets GSPMD partition the per-frame programs: XLA inserts the
convs' halo exchanges and the collectives that the warps' gathers and the
frame-wide sums need. This scales one 1080p or 4K stream's latency over
several chips, which batching cannot: each frame's DPB depends on the
previous frame. Eager torch has no partitioner, so the port splits by hand,
SPMD: one process per device, the same code on every rank.

The tiling rule (JAX's engine.py `_sp_put_leaf`, `shard_spatial_dpb`):
rank r of n holds rows [r H/n, (r+1) H/n) of every plane whose H divides n
and is above 1; every other plane is whole on every rank. A plane's global
H follows from its width: W is never split, and in a frame of H x W (both
multiples of 64) the plane of width w has H w / W rows. So every op reads
the frame's size (`SpatialAxis.frame`, set by the engines and by
`spatial_forward` around each call, per thread) and the plane's width, and
knows whether its input is split, where its rows start and what its output
must hold:
- a conv takes halo rows from its neighbours (`halo`: k//2 each side for a
  stride-1 k x k conv, one on top for the 3x3 stride-2 conv, none for 1x1)
  with zero rows at the frame's top and bottom, the conv's own padding;
- an op whose local result would not be exactly its rows of the global
  result first gathers its input whole (`gather_plane`): a stride-2 conv
  or pooling of a slice with an odd number of rows (its output does not
  tile: it is whole), a halo deeper than a neighbour's slice (SpyNet's 7x7
  convs at its coarse levels); its output is then split or whole by the
  rule;
- a whole plane whose output tiles (an upsampler from H/64 to H/32, say)
  computes its rows from the whole input;
- the flows' bilinear resizes run on the flow gathered whole (`resize`);
- the warps gather the image plane whole and run kernel A or D on the
  rank's flow rows with the row window (`row0`);
- frame-wide sums (the SE layers' means, bpp, mse) add the ranks' f32
  partial sums (`sum_over`), and the checkerboard masks take their parity
  from the global row.
Halos and gathers are all_gather_into_tensor calls (gloo takes CUDA tensors
there; send/recv under gloo with CUDA tensors was never checked), one a
halo and one a gather; every rank makes the same calls in the same order,
since each decision follows from the frame's size alone. Planes that are
whole are computed alike on every rank and stay bit-equal there.

`shard_spatial_model` swaps the model's Conv2d, SubpelConv and SELayer for
their spatial forms (below) and puts the axis on the modules that call
resampling, warps and sums themselves (`spatial` attribute), the way
parallel/tensor.shard_params_tp swaps the column-parallel layers; there is
no process-global switch, so concurrent sessions of other codecs are
untouched. Kernels B and C run unchanged on each rank's rows. Inference
only, as in the JAX package.

Usage, every rank:
    mesh = make_spatial_mesh(n)
    shard_spatial_model(model, mesh)
    fwd = spatial_forward(model, mesh, is_first_p=True)
    out = fwd(shard_spatial(x, mesh), shard_spatial_dpb(dpb, mesh), 1., 1.)
    whole = gather_spatial(out["dpb"], mesh, height, width)
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops import rowwise
from ..ops.layers import Conv2d, SELayer, SubpelConv
from ..ops.subpel import pixel_shuffle_relayout, subpel_conv1x1
from ..ops.warp import flow_warp_packed
from ..ops.warp_twopass import flow_warp_twopass
from . import mesh as pm

CL = torch.channels_last
# collectives this process issued, by kind: "halo" (boundary rows of a
# conv or an upsample), "gather_plane" (a plane made whole), "sum_over"
# (frame-wide partial sums)
COLLECTIVES: Counter = Counter()


def reset_collectives() -> None:
    COLLECTIVES.clear()


def tiles(h: int, n: int) -> bool:
    """Whether a plane of h rows is split over n ranks (JAX's rule)."""
    return h % n == 0 and h > 1


def make_spatial_mesh(n_devices: Optional[int] = None,
                      device_type: str = "cuda"):
    """A one-dimensional DeviceMesh named "spatial" over the ranks;
    n_devices, if given, must be the world size."""
    return pm.make_mesh(n_devices, axis="spatial", device_type=device_type)


def _nhwc(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The NHWC view of a plane whose H is `dim` (2: NCHW, 1: NHWC)."""
    return x.permute(0, 2, 3, 1) if dim == 2 else x


def _back(y: torch.Tensor, dim: int) -> torch.Tensor:
    return y.permute(0, 3, 1, 2) if dim == 2 else y


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor as uint8, so that any dtype travels bit for
    bit through any backend."""
    return t.contiguous().view(torch.uint8)


def _own(t: torch.Tensor, dim: int, r0: int, r1: int) -> torch.Tensor:
    t = t.narrow(dim, r0, r1 - r0)
    return t.contiguous(memory_format=CL) if dim == 2 else t.contiguous()


def _slice_conv(x, w, hg: int):
    """The conv for a slice of rows of plane x (hg rows whole), such that
    its output rows are bit for bit those of the whole plane's conv; None
    where there is none (the caller gathers the plane). On the card,
    F.conv2d. On the CPU PyTorch picks the conv's kernel by the input's
    size (ATen's ConvParams::use_mkldnn: oneDNN for an f32 input of more
    than 20480 elements a row, or a kernel over 3 x 3; else its own
    im2col conv, whose sums follow the input's height): a slice takes
    oneDNN explicitly when the whole plane would, and is gathered when
    it would not."""
    if x.device.type != "cpu":
        return F.conv2d
    _, c, _, width = x.shape
    k = w.shape[2]
    if x.dtype != torch.float32 or not (k > 3 or c * hg * width > 20480):
        return None

    def conv(t, w, b, stride, padding):
        return torch.ops.aten.mkldnn_convolution(
            t, w, b, padding, (stride, stride), (1, 1), 1)

    return conv


class SpatialAxis:
    """A rank's place on the spatial axis: the axis's process group, its
    size n and this rank's index; per thread, the size of the frame being
    coded (`frame`), from which every plane's rows follow."""

    def __init__(self, group, n: int, rank: int):
        self.group, self.n, self.rank = group, n, rank
        self._local = threading.local()

    # ------------------------------------------------------------ geometry
    @contextlib.contextmanager
    def frame(self, height: int, width: int):
        """Within the block (this thread), planes belong to a frame of
        height x width (global; both multiples of 64, the height split
        over the ranks)."""
        if height % 64 or width % 64 or not tiles(height, self.n):
            raise ValueError(f"spatial sharding codes frames whose sides "
                             f"are multiples of 64 and whose height splits "
                             f"over {self.n} ranks, not {height}x{width}")
        prev = getattr(self._local, "hw", None)
        self._local.hw = (height, width)
        try:
            yield self
        finally:
            self._local.hw = prev

    def frame_hw(self) -> tuple:
        hw = getattr(self._local, "hw", None)
        if hw is None:
            raise RuntimeError("a spatial model runs inside "
                               "SpatialAxis.frame(height, width) (the "
                               "engines and spatial_forward set it)")
        return hw

    def span(self, hg: int) -> tuple:
        """The rows [r0, r1) this rank holds of a plane of hg rows."""
        if not tiles(hg, self.n):
            return 0, hg
        k = hg // self.n
        return self.rank * k, (self.rank + 1) * k

    def split(self, hg: int) -> bool:
        return tiles(hg, self.n)

    def global_rows(self, t: torch.Tensor, dim: int) -> int:
        """The global rows of plane `t` (H at `dim`), from its width;
        raises if t does not hold this rank's rows of it."""
        height, width = self.frame_hw()
        w = t.shape[dim + 1]
        if w < 1 or width % w:
            raise ValueError(f"a plane {tuple(t.shape)} is no plane of a "
                             f"{height}x{width} frame")
        hg = height // (width // w)
        r0, r1 = self.span(hg)
        if t.shape[dim] != r1 - r0:
            raise ValueError(f"a plane of width {w} has {hg} rows in a "
                             f"{height}x{width} frame, of which rank "
                             f"{self.rank} holds {r1 - r0}, not "
                             f"{t.shape[dim]} ({tuple(t.shape)})")
        return hg

    def row0(self, t: torch.Tensor, dim: int) -> int:
        """The global row of t's first row."""
        return self.span(self.global_rows(t, dim))[0]

    def own_rows(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's rows of a whole plane (all of it when it does not
        tile); no communication."""
        r0, r1 = self.span(t.shape[dim])
        return t if r1 - r0 == t.shape[dim] else _own(t, dim, r0, r1)

    # --------------------------------------------------------- collectives
    def _all_gather(self, local: torch.Tensor) -> torch.Tensor:
        """(n, *local.shape): every rank's contiguous `local`, in rank
        order (gloo wants the ranks' blocks along dim 0 of one output)."""
        buf = torch.empty((self.n * local.shape[0], *local.shape[1:]),
                          dtype=local.dtype, device=local.device)
        dist.all_gather_into_tensor(_as_bytes(buf), _as_bytes(local),
                                    group=self.group)
        return buf.view(self.n, *local.shape)

    def gather_plane(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole plane from every rank's rows (all-gather along H);
        NCHW stays channels_last, NHWC contiguous."""
        xh = _nhwc(x, dim)
        local = xh.transpose(0, 1).contiguous()  # rows outermost
        buf = self._all_gather(local).flatten(0, 1)
        COLLECTIVES["gather_plane"] += 1
        return _back(buf.transpose(0, 1).contiguous(), dim)

    def whole(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Plane t whole: gathered when it is split, else t."""
        if self.split(self.global_rows(t, dim)):
            return self.gather_plane(t, dim)
        return t

    def halo(self, x: torch.Tensor, top: int, bottom: int,
             dim: int) -> torch.Tensor:
        """x with `top` rows of the rank above and `bottom` rows of the
        rank below around it, zero rows beyond the frame's top and bottom
        (a conv's padding): one all-gather of every rank's edge rows."""
        xh = _nhwc(x, dim)
        h = xh.shape[1]
        if top > h or bottom > h:
            raise ValueError(f"a halo of {top} / {bottom} rows from "
                             f"slices of {h}")
        if top == 0 and bottom == 0:
            return x
        # first `bottom` rows (the rank above's bottom halo), then the last
        # `top` rows (the rank below's top halo)
        edge = torch.cat([xh[:, :bottom], xh[:, h - top:]], 1)
        local = edge.transpose(0, 1).contiguous()
        buf = self._all_gather(local)
        COLLECTIVES["halo"] += 1
        zeros = torch.zeros_like(local)
        above = buf[self.rank - 1, bottom:] if self.rank else zeros[bottom:]
        below = (buf[self.rank + 1, :bottom] if self.rank < self.n - 1
                 else zeros[:bottom])
        out = torch.cat([above.transpose(0, 1), xh, below.transpose(0, 1)], 1)
        return _back(out.contiguous(), dim)

    def sum_over(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's t, added in rank order on every rank
        (an all-gather of the partial sums), so all ranks get the same
        bits."""
        buf = self._all_gather(t.contiguous())
        COLLECTIVES["sum_over"] += 1
        out = buf[0]
        for i in range(1, self.n):
            out = out + buf[i]
        return out

    # ---------------------------------------------------------------- ops
    def conv2d(self, x, w, b, stride: int, padding: int) -> torch.Tensor:
        """F.conv2d (through ops/rowwise) of plane x (NCHW, channels_last)
        with a square kernel: halo rows around a split input, or the
        whole input where the halo would not reach or, on the CPU, the
        slice would not take the whole plane's conv kernel (module
        docstring)."""
        k = w.shape[2]
        hg = self.global_rows(x, 2)
        hout = (hg + 2 * padding - k) // stride + 1
        if not self.split(hg):  # whole in, whole out
            return rowwise.conv2d(x, w, b, stride, padding)
        if k == 1 and stride == 1:  # pixel by pixel
            return rowwise.conv2d(x, w, b)
        i0, i1 = self.span(hg)
        conv = _slice_conv(x, w, hg)
        if self.split(hout) and conv is not None:
            o0, o1 = self.span(hout)
            top = i0 - (o0 * stride - padding)
            bottom = (o1 - 1) * stride - padding + k - i1
            if 0 <= top <= i1 - i0 and bottom <= i1 - i0:
                xe = self.halo(x, top, max(bottom, 0), 2)
                y = rowwise.per_row(conv, xe, w, b, stride, (0, padding))
                return y if y.shape[2] == o1 - o0 else _own(y, 2, 0, o1 - o0)
        y = rowwise.conv2d(self.gather_plane(x, 2), w, b, stride, padding)
        return self.own_rows(y, 2)

    def pool(self, fn, x: torch.Tensor) -> torch.Tensor:
        """fn(x) for a 2x2 pooling (output row j from input rows 2j and
        2j + 1): local on a slice of even rows; a slice of odd rows is
        gathered (the output is whole)."""
        hg = self.global_rows(x, 2)
        if not self.split(hg) or self.split(hg // 2):
            return fn(x)
        return fn(self.gather_plane(x, 2))

    def resize(self, fn, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of fn (bilinear_up2 or bilinear_down2) of plane
        x, resized whole. A slice with a halo row would give the same rows
        in exact arithmetic, but PyTorch's CPU resize rounds otherwise on
        other input sizes (slices of a 2 x 48 x 32 flow upsampled, or of a
        2 x 192 x 128 one downsampled: outputs 1 ulp off), and the planes
        resized are the 2-channel flows, the smallest to move."""
        return self.own_rows(fn(self.whole(x, 2)), 2)

    def warp(self, ims, flow) -> list:
        """flow_warp_packed: each image gathered whole, kernel A on this
        rank's flow rows (the row window)."""
        hg = self.global_rows(flow, 2)
        if not self.split(hg):
            return flow_warp_packed(ims, flow)
        return flow_warp_packed([self.gather_plane(im, 2) for im in ims],
                                flow, row0=self.span(hg)[0])

    def warp_twopass(self, im, flow, max_disp: int) -> torch.Tensor:
        """flow_warp_twopass: the image gathered whole, kernel D on this
        rank's flow rows."""
        hg = self.global_rows(flow, 2)
        if not self.split(hg):
            return flow_warp_twopass(im, flow, max_disp)
        return flow_warp_twopass(self.gather_plane(im, 2), flow, max_disp,
                                 row0=self.span(hg)[0])

    def sum_plane(self, t: torch.Tensor) -> torch.Tensor:
        """torch.sum over (H, W, C) of an NHWC plane, per row of N, over
        the whole frame."""
        s = torch.sum(t, dim=(1, 2, 3))
        return self.sum_over(s) if self.split(self.global_rows(t, 1)) else s

    def mean_hw(self, x: torch.Tensor) -> torch.Tensor:
        """ops/rowwise.mean_hw (f32, (N, C)) over the whole frame."""
        hg = self.global_rows(x, 2)
        if not self.split(hg):
            return rowwise.mean_hw(x)
        s = rowwise.per_row(lambda t: t.sum(dim=(2, 3), dtype=torch.float32),
                            x)
        return self.sum_over(s) / float(hg * x.shape[3])


def spatial_axis(mesh) -> SpatialAxis:
    """This rank's SpatialAxis on a one-dimensional mesh."""
    return SpatialAxis(mesh.get_group(), mesh.size(), mesh.get_local_rank())


# ------------------------------------------------------------ spatial layers
class SpatialConv2d(Conv2d):
    """Conv2d on this rank's rows (SpatialAxis.conv2d)."""

    spatial: Optional[SpatialAxis] = None

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        w = self.weight.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        (s, _), (p, _) = self.stride, self.padding
        return self.spatial.conv2d(x.to(dt), w, b, s, p)


class SpatialSubpelConv(SubpelConv):
    """SubpelConv on this rank's rows: kernel B (kernel 1) or the conv
    with its halo and then kernel C (kernel 3) on the local rows; from a
    whole input to a split output, on the input rows of this rank's output
    rows."""

    spatial: Optional[SpatialAxis] = None

    def forward(self, x):
        w, b = self.kmajor_weights()
        dt = torch.promote_types(x.dtype, w.dtype)
        x = x.to(dt).contiguous(memory_format=CL)
        w, b = w.to(dt), b.to(dt)
        sp, r = self.spatial, self.r
        if self.kernel == 1:
            def op(t):
                return subpel_conv1x1(t.contiguous(memory_format=CL), w, b, r)
        else:
            x = sp.conv2d(x, w, b, 1, self.kernel // 2)

            def op(t):
                return pixel_shuffle_relayout(t.contiguous(memory_format=CL),
                                              r)
        hg = sp.global_rows(x, 2)
        if sp.split(hg) or not sp.split(hg * r):
            return op(x)
        o0, o1 = sp.span(hg * r)
        if o0 % r == 0 and o1 % r == 0:
            return op(_own(x, 2, o0 // r, o1 // r))
        return _own(op(x), 2, o0, o1)


class SpatialSELayer(SELayer):
    """SELayer whose channel means cover the whole frame."""

    spatial: Optional[SpatialAxis] = None

    def forward(self, x):
        y = self.spatial.mean_hw(x).to(x.dtype)
        return x * self.fc(y)[:, :, None, None]


SPATIAL_FORMS = {Conv2d: SpatialConv2d, SubpelConv: SpatialSubpelConv,
                 SELayer: SpatialSELayer}


def shard_spatial_model(model: torch.nn.Module, mesh) -> SpatialAxis:
    """Swap, in place, every Conv2d, SubpelConv and SELayer of `model` for
    its spatial form, and set the axis on every module with a `spatial`
    attribute (the models and the modules that resample, warp or sum
    themselves); returns this rank's SpatialAxis. Every rank must hold the
    same weights (parallel/mesh.replicate)."""
    axis = spatial_axis(mesh)
    for m in model.modules():
        if type(m) in SPATIAL_FORMS.values():
            raise ValueError("the model is already split by rows")
    for m in model.modules():
        form = SPATIAL_FORMS.get(type(m))
        if form is not None:
            m.__class__ = form
        if hasattr(type(m), "spatial"):
            m.spatial = axis
    return axis


def spatial_forward(model: torch.nn.Module, mesh, is_first_p: bool = False):
    """The per-frame forward of a DMC split by shard_spatial_model over
    `mesh`: fwd(x, dpb, mv_q, y_q) -> the forward's dict, without
    gradients (JAX's jitted spatial_forward): x and the DPB as
    shard_spatial / shard_spatial_dpb give them, the outputs' planes this
    rank's rows (gather_spatial joins them), the bits and bpp whole."""
    axis = model.spatial
    if axis is None:
        raise ValueError("spatial_forward takes a model split by "
                         "shard_spatial_model")

    @torch.no_grad()
    def fwd(x, dpb, mv_q, y_q):
        with axis.frame(axis.n * x.shape[1], x.shape[2]):
            return model(x, dpb, mv_q, y_q, is_first_p, training=False)

    return fwd


def map_tree(fn, tree):
    """fn of each leaf of a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def shard_spatial(x, mesh):
    """This rank's rows of a whole NHWC plane (a tensor, or a numpy array
    made a CPU tensor) that tiles the mesh; a plane that does not, whole."""
    axis = mesh if isinstance(mesh, SpatialAxis) else spatial_axis(mesh)
    x = torch.as_tensor(x)
    return axis.own_rows(x, 1) if x.dim() == 4 else x


def shard_spatial_dpb(dpb: dict, mesh) -> dict:
    """shard_spatial of each DPB plane: planes too small to split (the
    1/16-res latents on a large mesh) stay whole."""
    return {k: shard_spatial(v, mesh) for k, v in dpb.items()}


def replicate(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """The module whole on every rank: its parameters and buffers
    broadcast from the axis's first rank, in place (parallel/mesh.replicate
    over the spatial mesh)."""
    return pm.replicate(module, mesh)


def gather_spatial(tree, mesh, height: int, width: int):
    """Whole planes from every rank's rows (the port's stand-in for a
    global jax.Array): each 4-D NHWC tensor of `tree`, a plane of a
    height x width frame, gathered where it is split; anything else as it
    is. A collective: every rank calls it."""
    axis = mesh if isinstance(mesh, SpatialAxis) else spatial_axis(mesh)

    def whole(t):
        if isinstance(t, torch.Tensor) and t.dim() == 4:
            return axis.whole(t, 1)
        return t

    with axis.frame(height, width):
        return map_tree(whole, tree)
