"""Weight sharding: fully sharded data parallelism and tensor parallelism
(the port's counterpart of vcm_ts_tpu/parallel/tensor.py, behind
trainer_multi --fsdp and --tp).

FSDP. The JAX package shards every weight and both Adam moments over the
batch's own "data" axis (`shard_params_tp(params, mesh, axis="data")`) and
GSPMD gathers each weight where a layer needs it. The port does the same
with torch's fully_shard (FSDP2) over the "data" DeviceMesh: each
parameter is split along its first dimension into one shard per rank,
gathered whole for the forward and the backward, and its gradient
reduce-scattered (the mean over the ranks) back into shards. The
StageOptimizer built after sharding keeps its moments in the same shards,
so weights, gradients and moments all take about 1/n of their size per
rank.

The quantization-scale tables `mv_y_q_scale` / `y_q_scale` are read
outside the model's forward (the train step slices them per rate anchor),
so they stay whole on every rank (`OUTSIDE_FORWARD`), and the step averages
their gradients with parallel/mesh.reduce_gradients.

Under bf16 compute the shards stay f32 masters and FSDP gathers them as
bf16 (`MixedPrecisionPolicy(param_dtype=bf16, reduce_dtype=f32)`), except
the bit estimators: their own groups gather f32, as the JAX step keeps
them (`_MP_KEEP_F32`).

Tensor parallelism. The JAX package shards the last (output-channel) dim
of every leaf over a "model" mesh axis where the dim divides the axis
(`tp_spec`) and lets GSPMD partition the convs. DTensor's conv rule keeps
the input's sharding and never splits output channels, and it cannot see
through the ctypes launches of kernels A-D, so the port splits by hand,
Megatron's column-parallel way: `shard_params_tp` swaps every Conv2d,
Linear and SubpelConv whose output channels split (`tp_split`, the rule of
tp_spec on dim 0, torch's output-channel dim) for its column-parallel form
(below), which holds the rank's block of output channels,
computes them from the whole input, and all-gathers them along C. Two
autograd collectives carry it, written with c10d calls (DTensor's
functional collectives crashed a rank under gloo with CUDA tensors):
- `copy_to_model`: identity forward; backward, the all-reduce (sum) of d
  input over the model group (each rank's slice gives a part of it);
- `gather_from_model`: all-gather along C forward; backward, the rank's
  own slice of the gradient.
A SubpelConv splits by features, i.e. its conv's output channels in
groups of r^2, so a rank keeps whole sub-pixel groups and the shuffle
stays local: its child conv keeps c-major rows [k f/n r^2, (k+1) f/n r^2)
of the whole conv, the k-major form is derived from that slice as for f/n
features, and kernel B (1x1) or the conv and kernel C (3x3) run on the
rank's channels alone. Layers whose channels do not split stay whole on
every rank, and so do the bit estimators and the q-scale parameters (not
convs). Kernels A and A' see the gathered, whole tensors. The split
parameters are ordinary tensors (the rank's slice), so gradients,
clipping and the Adam moments follow the slices. The gradients of whole
parameters are equal on the model ranks in exact arithmetic (every
activation they see is whole, and the copy's backward all-reduce makes
each d input whole), but nothing makes two ranks' kernels sum them in one
order (their slices' layouts and the collectives' buffers differ), so the
train step broadcasts them
from model rank 0 (parallel/mesh.broadcast_whole_grads) and the whole
parameters stay bit-equal over the model group. The port's split of a SubpelConv differs from JAX's
contiguous split of its c-major dim (JAX splits the 3-feature RGB heads,
whose 12 conv channels divide 2; the port keeps them whole): the numbers
are the same, the count of split leaves is not.

No `constrain_tp` counterpart: it pins the layout of a jitted step's
outputs against GSPMD's drift, and eager torch keeps every tensor where
it was put.
"""

from __future__ import annotations

import copy
from collections import Counter
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from ..ops.layers import Conv2d, Linear, SubpelConv
from ..utils.precision import MP_KEEP_F32

# parameters the train step reads outside the model's forward
OUTSIDE_FORWARD = ("mv_y_q_scale", "y_q_scale")
# collectives of tensor parallelism this process issued, by kind
# ("all_gather" forward, "all_reduce" backward, "broadcast" of the whole
# parameters' gradients, "gather_whole")
COLLECTIVES: Counter = Counter()


def shard_params_fsdp(model: nn.Module, mesh,
                      compute_dtype: Optional[torch.dtype] = None
                      ) -> nn.Module:
    """fully_shard `model` over `mesh` in place (one group for the model,
    and, with compute_dtype, one f32 group per bit estimator); returns
    it. Build the optimizer after this: sharding replaces the
    parameters."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

    ignored = {p for n, p in model.named_parameters()
               if n in OUTSIDE_FORWARD}
    with torch.no_grad():
        # fully_shard splits contiguous tensors only: the conv weights
        # leave channels_last (the convs take either layout)
        for p in model.parameters():
            p.data = p.data.contiguous()
    policy = MixedPrecisionPolicy()
    if compute_dtype is not None:
        policy = MixedPrecisionPolicy(param_dtype=compute_dtype,
                                      reduce_dtype=torch.float32)
        for name, child in model.named_children():
            if any(k in name for k in MP_KEEP_F32):
                fully_shard(child, mesh=mesh, mp_policy=MixedPrecisionPolicy(
                    param_dtype=torch.float32, reduce_dtype=torch.float32,
                    cast_forward_inputs=True))
    fully_shard(model, mesh=mesh, mp_policy=policy, ignored_params=ignored)
    return model


def is_sharded(model: nn.Module) -> bool:
    """Whether fully_shard manages the model's parameters."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


# -------------------------------------------------------------- tensor parallel
class ModelAxis(NamedTuple):
    """A rank's place on the "model" axis: the axis's process group, the
    rank's index on it and the axis's size."""
    group: object
    rank: int
    size: int


def model_axis(mesh) -> ModelAxis:
    """This rank's ModelAxis on a data x model mesh
    (parallel/mesh.make_dp_tp_mesh)."""
    sub = mesh["model"]
    return ModelAxis(sub.get_group(), sub.get_local_rank(), sub.size())


def tp_split(shape, n: int) -> bool:
    """Whether a tensor of `shape` splits over n model ranks: its first
    (output-channel) dim divides by n and is at least n (JAX's tp_spec on
    the last dim of a flax leaf)."""
    return len(shape) > 0 and shape[0] % n == 0 and shape[0] >= n


def reset_collectives() -> None:
    COLLECTIVES.clear()


def _records(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _all_gather(y: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    """The model ranks' blocks of `y` along `dim`, joined in rank order.
    The blocks travel with `dim` innermost (NHWC for an NCHW tensor), so a
    channels_last activation goes out as it lies, and comes back
    channels_last."""
    local = y.movedim(dim, -1).contiguous()
    buf = local.new_empty((axis.size * local.shape[0], *local.shape[1:]))
    dist.all_gather_into_tensor(buf, local, group=axis.group)
    COLLECTIVES["all_gather"] += 1
    parts = buf.reshape(axis.size, *local.shape).movedim(0, -2)
    return parts.reshape(*local.shape[:-1], -1).movedim(-1, dim)


def _own_block(g: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    k = g.shape[dim] // axis.size
    block = g.narrow(dim, axis.rank * k, k)
    if block.dim() == 4:
        return block.contiguous(memory_format=torch.channels_last)
    return block.contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.preserve_format)
        dist.all_reduce(g, group=ctx.axis.group)
        COLLECTIVES["all_reduce"] += 1
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _all_gather(y, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _own_block(g, ctx.dim, ctx.axis), None, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The input of a column-parallel layer: x itself; while autograd
    records, its gradient is all-reduced (summed) over the model group."""
    if _records(x):
        return _CopyToModel.apply(x, axis)
    return x


def gather_from_model(y: torch.Tensor, dim: int,
                      axis: ModelAxis) -> torch.Tensor:
    """The whole output of a column-parallel layer from each rank's block
    `y` along `dim`; the gradient of the whole goes back as this rank's
    block of it."""
    if _records(y):
        return _GatherFromModel.apply(y, dim, axis)
    return _all_gather(y, dim, axis)


class ColumnParallel:
    """Mixin of the column-parallel layers: `tp` is the rank's place on
    the model axis (ModelAxis), and every parameter of the
    layer and of its children holds the rank's block of dim 0 of the whole
    tensor."""

    tp = None


def _slice_param(p: nn.Parameter, axis) -> nn.Parameter:
    k = p.shape[0] // axis.size
    block = p.detach().narrow(0, axis.rank * k, k).clone()
    return nn.Parameter(block, requires_grad=p.requires_grad)


def _split_dense(cls, whole, axis):
    """A copy of a Conv2d or Linear as class `cls`: the same
    configuration, this rank's block of output channels."""
    layer = copy.copy(whole)  # configuration and hooks; parameters below
    layer.__class__ = cls
    layer._parameters = {
        name: None if p is None else _slice_param(p, axis)
        for name, p in whole._parameters.items()}
    for attr in ("out_channels", "out_features"):
        if hasattr(whole, attr):
            setattr(layer, attr, getattr(whole, attr) // axis.size)
    if issubclass(cls, ColumnParallel):
        layer.tp = axis
    return layer


class ColumnParallelConv2d(ColumnParallel, Conv2d):
    """Conv2d holding its rank's block of output channels."""

    @classmethod
    def split(cls, whole: Conv2d, axis) -> "ColumnParallelConv2d":
        return _split_dense(cls, whole, axis)

    def forward(self, x):
        y = super().forward(copy_to_model(x, self.tp))
        return gather_from_model(y, 1, self.tp)


class ColumnParallelLinear(ColumnParallel, Linear):
    """Linear holding its rank's block of output features."""

    @classmethod
    def split(cls, whole: Linear, axis) -> "ColumnParallelLinear":
        return _split_dense(cls, whole, axis)

    def forward(self, x):
        y = super().forward(copy_to_model(x, self.tp))
        return gather_from_model(y, y.dim() - 1, self.tp)


class ColumnParallelSubpelConv(ColumnParallel, SubpelConv):
    """SubpelConv holding its rank's block of features (whole groups of
    r^2 conv channels)."""

    @classmethod
    def split(cls, whole: SubpelConv, axis) -> "ColumnParallelSubpelConv":
        layer = cls.__new__(cls)
        nn.Module.__init__(layer)
        layer.features = whole.features // axis.size
        layer.r, layer.kernel = whole.r, whole.kernel
        layer._kmajor = None
        # the child's forward is never called: its slice feeds the k-major
        # weights
        layer.add_module("0", _split_dense(Conv2d, whole._modules["0"], axis))
        layer.tp = axis
        return layer

    def forward(self, x):
        y = super().forward(copy_to_model(x, self.tp))
        return gather_from_model(y, 1, self.tp)


def split_params(model: nn.Module) -> dict:
    """{parameter name: ModelAxis} of the parameters that shard_params_tp
    split (each holds its rank's block of dim 0); {} for a whole model."""
    out = {}
    for mname, m in model.named_modules():
        if isinstance(m, ColumnParallel):
            for pname, _ in m.named_parameters(prefix=mname):
                out[pname] = m.tp
    return out


def gather_whole(t: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """A split parameter's (or moment's) whole tensor from the model
    ranks' blocks of dim 0, in rank order (a collective of the model
    group); t itself when axis is None."""
    if axis is None:
        return t
    local = t.detach().contiguous()
    out = local.new_empty((axis.size * local.shape[0], *local.shape[1:]))
    dist.all_gather_into_tensor(out, local, group=axis.group)
    COLLECTIVES["gather_whole"] += 1
    return out


def own_slice(whole: torch.Tensor, axis: Optional[ModelAxis]
              ) -> torch.Tensor:
    """This rank's block of dim 0 of a whole tensor (no communication);
    whole itself when axis is None."""
    if axis is None:
        return whole
    k = whole.shape[0] // axis.size
    return whole.narrow(0, axis.rank * k, k)


def shard_params_tp(model: nn.Module, mesh) -> int:
    """Swap, in place, every Conv2d, Linear and SubpelConv of `model`
    whose output channels split over mesh's "model" axis for its
    column-parallel form holding this rank's slice (a SubpelConv counts
    its features, not its conv's channels, and is swapped whole); returns
    the number of split parameters. Build the optimizer after this:
    sharding replaces the parameters. Every rank must hold the same whole
    weights first (parallel/mesh.replicate)."""
    axis = model_axis(mesh)

    def visit(parent: nn.Module):
        for name, child in parent.named_children():
            if isinstance(child, ColumnParallel):
                raise ValueError("the model is already split")
            if isinstance(child, SubpelConv):
                if tp_split((child.features,), axis.size):
                    parent._modules[name] = \
                        ColumnParallelSubpelConv.split(child, axis)
                continue
            kind = {Conv2d: ColumnParallelConv2d,
                    Linear: ColumnParallelLinear}.get(
                        type(child))
            if kind is not None:
                if tp_split(child.weight.shape, axis.size):
                    parent._modules[name] = kind.split(child, axis)
                continue
            visit(child)

    visit(model)
    return len(split_params(model))


def assert_params_sharded(model: nn.Module) -> int:
    """The number of split parameters; raises if there are none (a model
    never passed to shard_params_tp, or a one-rank model axis)."""
    split = split_params(model)
    if not split or all(a.size == 1 for a in split.values()):
        raise AssertionError("no parameter is split over 'model'")
    return len(split)


def tp_forward(model: nn.Module, mesh, is_first_p: bool = False):
    """The per-frame forward of a DMC split by shard_params_tp over mesh's
    "model" axis: fwd(x, dpb, mv_q, y_q) -> the forward's dict, without
    gradients (JAX's jitted tp_forward; every model rank calls it on the
    same whole inputs and gets the same whole outputs)."""
    if model_axis(mesh).size > 1:
        assert_params_sharded(model)

    @torch.no_grad()
    def fwd(x, dpb, mv_q, y_q):
        return model(x, dpb, mv_q, y_q, is_first_p, training=False)

    return fwd
