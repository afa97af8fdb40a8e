"""Process groups, the "data" mesh and the collectives of data-parallel
training (the port's counterpart of vcm_ts_tpu/parallel/mesh.py).

One process per device, started by torchrun (`python -m
torch.distributed.run`), which sets RANK, WORLD_SIZE and LOCAL_RANK; a
caller that starts its processes itself sets them and passes an
`init_method` (a `file://` path needs no port). In the JAX package XLA
derives the gradient all-reduce from the mean loss over a batch sharded on
the "data" axis. Here each rank computes the loss of its own rows, and the
train step averages the gradients over the ranks once per step
(`reduce_gradients`), before clipping and the update, so every rank applies
the same update to the same weights: a data-parallel step equals a
one-process step on the global rows, up to the order of the sums.

Backends follow the device: NCCL for CUDA, gloo for the CPU. NCCL takes one
rank per device. Ranks may share a CUDA device only under gloo, and only
when the caller names gloo (`backend="gloo"`): gloo stages CUDA tensors
through the host, which checks the arithmetic but measures nothing of
NCCL.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

TP_WAITS = ("tensor parallelism (--tp > 1: column-parallel convs, kernel B's "
            "output channels split in groups of r^2) waits for ROADMAP.md "
            "Queue 1 item 7")
SPATIAL_WAITS = ("spatial sharding (parallel/spatial.py, "
                 "engine.set_spatial_sharding: halo exchanges) waits for "
                 "ROADMAP.md Queue 1 item 8")


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def initialize_distributed(backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           device="cuda") -> None:
    """Join the process group of torchrun's RANK and WORLD_SIZE (or of the
    caller's `init_method`). One process with neither torchrun's
    environment (MASTER_ADDR) nor an init_method is a no-op, as is a
    second call. On CUDA the rank's device (`local_device`) is made
    current before the group starts."""
    if dist.is_initialized():
        return
    world = _env_int("WORLD_SIZE", 1)
    if (world == 1 and init_method is None
            and "MASTER_ADDR" not in os.environ):
        return
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL needs CUDA tensors: pass backend='gloo' for "
                         "the CPU")
    if dev.type == "cuda":
        torch.cuda.set_device(local_device(dev, backend))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=_env_int("RANK", 0), world_size=world)


def local_device(device="cuda", backend: Optional[str] = None):
    """This rank's device: the CPU, or cuda:LOCAL_RANK. More ranks than
    devices on a host share them (LOCAL_RANK modulo the count) only under
    gloo; under NCCL that raises."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local, count = _env_int("LOCAL_RANK", 0), torch.cuda.device_count()
    if local < count:
        return torch.device("cuda", local)
    if backend is None and dist.is_initialized():
        backend = dist.get_backend()
    if backend != "gloo":
        raise RuntimeError(
            f"LOCAL_RANK {local} but {count} CUDA device(s): NCCL takes one "
            "rank per device (name backend gloo to share a device)")
    return torch.device("cuda", local % count)


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """A barrier over every rank (no-op in one process)."""
    if get_world_size() > 1:
        dist.barrier()


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device_type: str = "cuda"):
    """A one-dimensional DeviceMesh named `axis` over the ranks (JAX's
    Mesh; fully_shard takes it). n_devices, if given, must be the world
    size: one rank drives one device."""
    from torch.distributed.device_mesh import init_device_mesh

    world = get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs as many "
                         f"ranks; the world has {world}")
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


def make_global_mesh(axis: str = "data", device_type: str = "cuda"):
    """The "data" mesh over every rank of every host."""
    return make_mesh(None, axis, device_type)


def _mesh_rank_world(mesh) -> tuple:
    if mesh is None:
        return get_rank(), get_world_size()
    return mesh.get_local_rank(), mesh.size()


def global_batch(batch, mesh=None, batch_dim: int = 0):
    """This rank's rows of a global batch (a tensor, an array, or a dict,
    tuple or list of them): the global rows split into equal blocks in rank
    order along `batch_dim` (1 for cascade chains, (T, N, ...))."""
    rank, world = _mesh_rank_world(mesh)

    def rows(x):
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(rows(v) for v in x)
        n = x.shape[batch_dim]
        if n % world:
            raise ValueError(f"{n} rows do not split over {world} ranks")
        k = n // world
        if isinstance(x, torch.Tensor):
            return x.narrow(batch_dim, rank * k, k)
        return np.take(np.asarray(x), np.arange(rank * k, rank * k + k),
                       axis=batch_dim)

    return rows(batch)


def _buckets(tensors: list) -> dict:
    """Indexes of `tensors` grouped by (device, dtype)."""
    out: dict = {}
    for i, t in enumerate(tensors):
        out.setdefault((t.device, t.dtype), []).append(i)
    return out


def _coalesced(tensors: list, fn) -> list:
    """fn(flat) on one flat buffer per (device, dtype) of `tensors`; the
    results split back into tensors of the inputs' shapes."""
    out = list(tensors)
    for idx in _buckets(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        flat = fn(flat)
        for i, piece in zip(idx, torch.split(
                flat, [tensors[i].numel() for i in idx])):
            out[i] = piece.view_as(tensors[i])
    return out


def _mean(tensors: list, mesh) -> list:
    """Each tensor averaged over the ranks, one all-reduce per bucket."""
    _, world = _mesh_rank_world(mesh)
    group = None if mesh is None else mesh.get_group()

    def mean(flat):
        dist.all_reduce(flat, group=group)
        return flat / world

    return _coalesced(tensors, mean)


def reduce_gradients(grads: dict, mesh=None) -> dict:
    """The mean of a {name: gradient} dict over the ranks, one all-reduce
    per (device, dtype) bucket rather than one per tensor. None stays None
    (no gradient on any rank); a DTensor gradient (a parameter that
    fully_shard manages) is already reduced and passes through."""
    from torch.distributed.tensor import DTensor

    if _mesh_rank_world(mesh)[1] == 1:
        return dict(grads)
    names = [n for n, g in grads.items()
             if g is not None and not isinstance(g, DTensor)]
    out = dict(grads)
    out.update(zip(names, _mean([grads[n] for n in names], mesh)))
    return out


def mean_over_ranks(tensors: list, mesh=None) -> list:
    """Each tensor averaged over the ranks (one all-reduce per bucket)."""
    if _mesh_rank_world(mesh)[1] == 1:
        return list(tensors)
    return _mean([t.detach() for t in tensors], mesh)


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh=None) -> torch.nn.Module:
    """Rank 0's parameters and buffers broadcast to every rank, in place
    (one broadcast per bucket); returns the module."""
    _, world = _mesh_rank_world(mesh)
    if world == 1:
        return module
    group = None if mesh is None else mesh.get_group()
    src = 0 if mesh is None else dist.get_global_rank(group, 0)
    tensors = list(module.parameters()) + list(module.buffers())

    def bcast(flat):
        dist.broadcast(flat, src, group=group)
        return flat

    for t, v in zip(tensors, _coalesced(tensors, bcast)):
        t.copy_(v)
    return module


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """An FSDP-sharded DTensor whole on every rank (a collective every
    rank joins), or t itself. FSDP splits along dim 0 in torch.chunk's
    blocks (the last ones shorter or empty): one padded
    all_gather_into_tensor of the mesh's group joins them. (DTensor's own
    full_tensor goes through functional collectives, which crashed the
    process under gloo with CUDA tensors.)"""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    (place,) = t.placements
    if not place.is_shard(dim=0):
        raise NotImplementedError(f"gathering a DTensor split as {place}")
    local = t.to_local()
    world, n = t.device_mesh.size(), t.shape[0]
    rows = -(-n // world)
    buf = local.new_zeros((rows, *t.shape[1:]))
    buf[:local.shape[0]] = local
    out = local.new_empty((world * rows, *t.shape[1:]))
    dist.all_gather_into_tensor(out, buf, group=t.device_mesh.get_group())
    return out[:n]


def host_copy(module: torch.nn.Module) -> dict:
    """The module's whole state_dict on the host. Under FSDP each sharded
    tensor is gathered: a collective that every rank must join, never
    rank 0 alone."""
    return {k: full_tensor(v).detach().cpu().clone()
            for k, v in module.state_dict().items()}


def all_gather_metrics(obj):
    """[obj of each rank] in rank order (the JAX package's process
    allgather); one process: obj itself."""
    if get_world_size() == 1:
        return obj
    out = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out
