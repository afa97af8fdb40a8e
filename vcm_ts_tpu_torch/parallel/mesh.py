"""Process groups, the "data" and "data" x "model" meshes and the
collectives of data-parallel training (the port's counterpart of
vcm_ts_tpu/parallel/mesh.py).

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

Under tensor parallelism (parallel/tensor.py) the ranks form a data x
model mesh (`make_dp_tp_mesh`), the model axis the minor one: rank r has
data index r // n_model and model index r % n_model, and each axis has
its own process group. The ranks of one data index hold one copy of the
model, split over the model axis, and take the same rows. The helpers of
data parallelism here (`global_batch`, `reduce_gradients`,
`mean_over_ranks`, `replicate`) take either mesh and act over its "data"
axis alone (`data_mesh`).

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
from .tensor import COLLECTIVES, gather_whole, split_params

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


def make_dp_tp_mesh(n_data: int, n_model: int, device_type: str = "cuda"):
    """A two-dimensional ("data", "model") DeviceMesh over n_data * n_model
    ranks (the world), the model axis the minor one: rank r sits at (r //
    n_model, r % n_model). Each axis gets its own process groups, of the
    world's backend (NCCL on CUDA, gloo on the CPU). make_dp_tp_mesh(1, n)
    is the JAX package's make_tp_mesh(n)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = get_world_size()
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs as many ranks; "
                         f"the world has {world}")
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def make_global_dp_tp_mesh(n_model: int, device_type: str = "cuda"):
    """The data x model mesh over every rank (trainer_multi --tp): n_model
    ranks a model group, the world's other factor the data axis. A world
    size that n_model does not divide raises, and so does a host whose
    ranks (torchrun's LOCAL_WORLD_SIZE) it does not divide: a model group
    stays on one host, as the JAX package keeps the model axis inside one
    process's devices."""
    world = get_world_size()
    local = _env_int("LOCAL_WORLD_SIZE", world)
    if n_model < 1 or world % n_model or local % n_model:
        raise ValueError(f"--tp {n_model} must divide the world size {world}"
                         f" and the ranks of a host ({local})")
    return make_dp_tp_mesh(world // n_model, n_model, device_type)


def data_mesh(mesh):
    """The "data" axis of `mesh`: a one-dimensional mesh itself, the
    "data" sub-mesh of a data x model mesh; None stays None."""
    if mesh is None or getattr(mesh, "ndim", 1) == 1:
        return mesh
    return mesh["data"]


def model_size(mesh) -> int:
    """The size of the "model" axis of a data x model mesh (1 for None or
    a one-dimensional mesh)."""
    if mesh is None or getattr(mesh, "ndim", 1) == 1:
        return 1
    return mesh["model"].size()


def _mesh_rank_world(mesh) -> tuple:
    if mesh is None:
        return get_rank(), get_world_size()
    mesh = data_mesh(mesh)
    return mesh.get_local_rank(), mesh.size()


def _group(mesh):
    return None if mesh is None else data_mesh(mesh).get_group()


def global_batch(batch, mesh=None, batch_dim: int = 0):
    """This rank's rows of a global batch (a tensor, an array, or a dict,
    tuple or list of them): the global rows split into equal blocks in
    the order of the data axis along `batch_dim` (1 for cascade chains,
    (T, N, ...)); the ranks of one model group take the same rows."""
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
    """Each tensor averaged over the data axis, one all-reduce per
    bucket."""
    _, world = _mesh_rank_world(mesh)
    group = _group(mesh)

    def mean(flat):
        dist.all_reduce(flat, group=group)
        return flat / world

    return _coalesced(tensors, mean)


def reduce_gradients(grads: dict, mesh=None) -> dict:
    """The mean of a {name: gradient} dict over the data axis, one
    all-reduce per (device, dtype) bucket rather than one per tensor. None stays None
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


def broadcast_whole_grads(grads: dict, split, mesh=None) -> dict:
    """Under tensor parallelism, the gradients of the whole (unsplit)
    parameters as model rank 0 holds them, on every rank of its model
    group (one broadcast per bucket); `split` names the split parameters,
    whose gradients stay this rank's slice's. Without a model axis, grads
    itself."""
    if model_size(mesh) == 1:
        return grads
    names = [n for n, g in grads.items() if g is not None and n not in split]
    group = mesh["model"].get_group()
    src = dist.get_global_rank(group, 0)

    def bcast(flat):
        dist.broadcast(flat, src, group=group)
        COLLECTIVES["broadcast"] += 1
        return flat

    out = dict(grads)
    out.update(zip(names, _coalesced([grads[n] for n in names], bcast)))
    return out


def mean_over_ranks(tensors: list, mesh=None) -> list:
    """Each tensor averaged over the data axis (one all-reduce per
    bucket)."""
    if _mesh_rank_world(mesh)[1] == 1:
        return list(tensors)
    return _mean([t.detach() for t in tensors], mesh)


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh=None) -> torch.nn.Module:
    """The parameters and buffers of the data axis's first rank broadcast
    over the axis (without a mesh: global rank 0's to every rank), in
    place, one broadcast per bucket; returns the module. Under tensor
    parallelism each model index broadcasts its own slices."""
    _, world = _mesh_rank_world(mesh)
    if world == 1:
        return module
    group = _group(mesh)
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
    tensor is gathered, under tensor parallelism each split one (its
    slices in model-rank order): a collective that every rank must join,
    never rank 0 alone."""
    split = split_params(module)
    return {k: gather_whole(full_tensor(v), split.get(k)).detach().cpu()
            .clone() for k, v in module.state_dict().items()}


def max_over_ranks(value: float, device="cpu") -> float:
    """The largest of every rank's `value` (one all-reduce over the world
    on a tensor on `device`; one process: value itself)."""
    if get_world_size() == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def all_gather_metrics(obj):
    """[obj of each rank] in rank order (the JAX package's process
    allgather); one process: obj itself."""
    if get_world_size() == 1:
        return obj
    out = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out
