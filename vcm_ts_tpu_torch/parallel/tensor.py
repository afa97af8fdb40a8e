"""Fully sharded data parallelism (the FSDP half of
vcm_ts_tpu/parallel/tensor.py, behind trainer_multi --fsdp).

The JAX package shards every weight and both Adam moments over the batch's
own "data" axis (`shard_params_tp(params, mesh, axis="data")`) and GSPMD
gathers each weight where a layer needs it. The port does the same with
torch's fully_shard (FSDP2) over the "data" DeviceMesh: each parameter is
split along its first dimension into one shard per rank, gathered whole
for the forward and the backward, and its gradient reduce-scattered (the
mean over the ranks) back into shards. The StageOptimizer built after
sharding keeps its moments in the same shards, so weights, gradients and
moments all take about 1/n of their size per rank.

The quantization-scale tables `mv_y_q_scale` / `y_q_scale` are read
outside the model's forward (the train step slices them per rate anchor),
so they stay whole on every rank (`OUTSIDE_FORWARD`), and the step averages
their gradients with parallel/mesh.reduce_gradients.

Under bf16 compute the shards stay f32 masters and FSDP gathers them as
bf16 (`MixedPrecisionPolicy(param_dtype=bf16, reduce_dtype=f32)`), except
the bit estimators: their own groups gather f32, as the JAX step keeps
them (`_MP_KEEP_F32`).

Tensor parallelism (`--tp`, tp_spec, the data x model mesh) is not here:
`check_tp` raises and names ROADMAP.md Queue 1 item 7.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..utils.precision import MP_KEEP_F32
from .mesh import TP_WAITS

# parameters the train step reads outside the model's forward
OUTSIDE_FORWARD = ("mv_y_q_scale", "y_q_scale")


def check_tp(tp: int) -> None:
    if tp > 1:
        raise NotImplementedError(TP_WAITS)


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
