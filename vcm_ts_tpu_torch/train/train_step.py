"""Training steps of the DMC: the RD loss, `single` and `cascade`.

The port's counterpart of vcm_ts_tpu/train/train_step.py:
- `frame_loss`: the RD (+ optional perceptual) loss of one P-frame, batch
  rows cycling through the rate anchors (row i trains at lambda_i with
  q-scale row i), `anchor_start` / `anchor_count` slicing a microbatch of
  anchors, `compute_dtype` running the model on bf16 copies of the f32
  master parameters (utils/precision.cast_for_compute) with its outputs
  upcast to f32 before the loss;
- `make_single_frame_step`: one optimizer step per P-frame, the DPB passed
  on detached;
- `make_cascade_step`: the loss averaged over a chain of p_frames frames,
  backpropagated through the DPB (BPTT), each frame checkpointed
  (torch.utils.checkpoint, non-reentrant) when `remat`, and `accum_steps`
  microbatches of anchors whose gradients are summed, then divided by G,
  before one update;
- `run_single_sequence` / `run_cascade_sequence`: the outer loops over a
  (N, T, H, W, 3) sequence batch.

The model and the optimizer are objects updated in place (the JAX steps
return new parameter trees). Noise: torch's generators do not give
jax.random's draws, so a step takes its U(-0.5, 0.5) tensors as an
argument (`draw_noise`, `draw_cascade_noise` make them from a
torch.Generator). The cascade draws every frame's noise before the
checkpointed call: a checkpoint's recompute does not replay a custom
generator.

Steps run forward and backward inside ops/rowwise.whole_batch(): convs,
dense layers and SE means take the whole batch (the JAX train step gives
no row-exactness either). Gradients are taken for the trainable
parameters only (torch.autograd.grad), so a frozen module's weight
gradients are never computed; its activations' are, where BPTT needs them.

Data parallelism (`mesh`, the "data" DeviceMesh of parallel/mesh.py): each
rank runs its own rows, and the step averages the gradients over the ranks
once, before clipping and the update (parallel/mesh.reduce_gradients; with
accum_steps, the sum over the groups is reduced, then divided by G), and
averages FrameAux, so every rank holds the global values, as the JAX step's
replicated outputs are. The noise of a rank is its rows of the global
batch's noise (`draw_noise(..., mesh=)`), so a data-parallel step equals a
one-process step on the global rows. Under FSDP (the model sharded by
parallel/tensor.shard_params_fsdp) the sharded parameters are not leaves
of the graph: the step takes gradients with loss.backward() (all
parameters) and reads .grad, fully_shard reduce-scatters them (once per
step: the groups before the last skip the reduction), and only the few
whole parameters go through reduce_gradients.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..models.dmc import make_dpb
from ..ops import rowwise
from ..ops.math import uniform_noise
from ..parallel import mesh as pm
from ..parallel.tensor import is_sharded
from ..utils.precision import cast_for_compute


class FrameAux(NamedTuple):
    """Per-rate-anchor stats, each (anchor_num,): batch rows tiled over the
    anchors are averaged per anchor."""
    loss: torch.Tensor
    rate: torch.Tensor
    dist: torch.Tensor
    p_dist: torch.Tensor
    bpp: torch.Tensor
    psnr: torch.Tensor
    me_psnr: torch.Tensor


def _psnr(mse):
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-10))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [_map(v, fn) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            type(tree)(items)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _cast_tree(tree, dtype):
    return _map(tree, lambda v: v.to(dtype) if v.dtype == torch.float32
                else v)


def detach_tree(tree):
    return _map(tree, torch.Tensor.detach)


def _device(model):
    return next(model.parameters()).device


def draw_noise(model, x, generator: torch.Generator, mesh=None):
    """The four U(-0.5, 0.5) tensors DMC.forward takes for frame batch x
    (N, H, W, 3): y_res, mv_y_res, z, mv_z, in x's dtype on x's device.
    With a data mesh, x holds this rank's rows: the noise of the global
    batch (N times the ranks) is drawn, and this rank's rows kept."""
    n, h, w, _ = x.shape
    world = 1 if mesh is None else mesh.size()
    noise = tuple(uniform_noise(s, generator, x.dtype, x.device)
                  for s in model.noise_shapes(n * world, h, w))
    return noise if world == 1 else pm.global_batch(noise, mesh)


def draw_cascade_noise(model, xs, generator: torch.Generator,
                       accum_steps: int = 1, mesh=None):
    """A cascade step's noise for xs (p_frames, N, H, W, 3): per frame, or,
    with accum_steps G > 1, per group (G lists of per-frame noise for the
    group's N / G rows)."""
    if accum_steps == 1:
        return [draw_noise(model, x, generator, mesh) for x in xs]
    rows = xs.shape[1] // accum_steps
    return [[draw_noise(model, x[:rows], generator, mesh) for x in xs]
            for _ in range(accum_steps)]


def frame_loss(model, x, target, dpb, *, lambdas, dist_lambda, pl_lambda,
               loss_rate_keys: Sequence[str], loss_dist_key: str,
               pl_fn: Optional[Callable], noise, is_first_p: bool,
               training: bool = True, compute_dtype=None,
               anchor_start: Optional[int] = None,
               anchor_count: Optional[int] = None):
    """RD (+ perceptual) loss of one P-frame; returns (mean loss,
    (FrameAux, new DPB)). x, target and the DPB are NHWC; lambdas an f32
    tensor of the anchors' lambdas; noise the four tensors of draw_noise,
    or None (bits of the rounded values); pl_fn(target, recon) -> (N,)
    any callable."""
    params = None
    mv_q, y_q = model.mv_y_q_scale, model.y_q_scale
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        dpb = _cast_tree(dpb, compute_dtype)
        noise = _cast_tree(noise, compute_dtype)
        if is_sharded(model):
            # fully_shard gathers the weights in compute_dtype (its
            # MixedPrecisionPolicy); the q-scale tables it leaves whole
            mv_q, y_q = mv_q.to(compute_dtype), y_q.to(compute_dtype)
        else:
            params = cast_for_compute(model, compute_dtype)
            mv_q, y_q = params["mv_y_q_scale"], params["y_q_scale"]
    if anchor_start is not None:
        sl = slice(anchor_start, anchor_start + anchor_count)
        mv_q, y_q, lambdas = mv_q[sl], y_q[sl], lambdas[sl]
    reps = x.shape[0] // mv_q.shape[0]
    if reps > 1:
        mv_q = mv_q.repeat(reps, 1, 1, 1)
        y_q = y_q.repeat(reps, 1, 1, 1)
    if lambdas.shape[0] != x.shape[0]:
        lambdas = lambdas.repeat(x.shape[0] // lambdas.shape[0])
    args = (x, dpb, mv_q, y_q, is_first_p)
    kwargs = dict(training=training, noise=noise)
    if params is None:
        out = model(*args, **kwargs)
    else:
        out = functional_call(model, params, args, kwargs)
    if compute_dtype is not None:
        # loss and metric math, and the DPB carry, in f32
        out = _map(out, lambda v: v.float() if v.dtype == compute_dtype
                   else v)

    rate = torch.zeros_like(lambdas)
    for key in loss_rate_keys:
        rate = rate + out[key]
    dist = out[loss_dist_key]
    if pl_fn is not None:
        p_dist = pl_fn(target, out["dpb"]["ref_frame"])
    else:
        p_dist = torch.zeros_like(lambdas)
    eff_lambdas = lambdas if len(loss_rate_keys) else torch.ones_like(
        lambdas)
    loss = rate + eff_lambdas * (dist * dist_lambda + p_dist * pl_lambda)

    n_anchors = (anchor_count if anchor_count is not None
                 else model.mv_y_q_scale.shape[0])

    def per_anchor(v):
        return v.reshape(-1, n_anchors).mean(0)

    aux = FrameAux(loss=per_anchor(loss), rate=per_anchor(rate),
                   dist=per_anchor(dist), p_dist=per_anchor(p_dist),
                   bpp=per_anchor(out["bpp"]),
                   psnr=per_anchor(_psnr(out["mse"])),
                   me_psnr=per_anchor(_psnr(out["me_mse"])))
    return loss.mean(), (aux, out["dpb"])


def _grads(loss, opt, model):
    """{name: gradient} of the optimizer's trainable parameters."""
    names = opt.names
    if opt.sharded:
        loss.backward()
        return _take_grads(model, opt)
    grads = torch.autograd.grad(loss, [opt.params[n] for n in names],
                                allow_unused=True)
    return dict(zip(names, grads))


def _take_grads(model, opt) -> dict:
    """The trainable parameters' .grad (what backward() left), cleared
    from every parameter for the next step."""
    grads = {n: opt.params[n].grad for n in opt.names}
    for p in model.parameters():
        p.grad = None
    return grads


def _sync(grads: dict, aux: FrameAux, mesh):
    """Gradients and FrameAux averaged over the data ranks (no-op without
    a mesh)."""
    if mesh is None:
        return grads, aux
    return (pm.reduce_gradients(grads, mesh),
            FrameAux(*pm.mean_over_ranks(list(aux), mesh)))


def _lambdas(model, lambdas):
    return torch.as_tensor(np.asarray(lambdas, np.float32),
                           device=_device(model))


def make_single_frame_step(model, opt, stage, *, lambdas, dist_lambda,
                           pl_lambda, pl_fn=None, compute_dtype=None,
                           mesh=None):
    """Per-frame gradient step of the 'single' strategy:
    step(x, target, dpb, noise, is_first_p) -> (FrameAux, new DPB), both
    detached; the model's parameters are updated in place by `opt`
    (train/optimizer.StageOptimizer). With `mesh`, x, the DPB and the noise
    hold this rank's rows (see the module docstring)."""
    lam = _lambdas(model, lambdas)

    def step(x, target, dpb, noise, is_first_p):
        with rowwise.whole_batch():
            loss, (aux, new_dpb) = frame_loss(
                model, x, target, dpb, lambdas=lam, dist_lambda=dist_lambda,
                pl_lambda=pl_lambda, loss_rate_keys=stage.loss_rate_keys,
                loss_dist_key=stage.loss_dist_key, pl_fn=pl_fn, noise=noise,
                is_first_p=is_first_p, compute_dtype=compute_dtype)
            grads = _grads(loss, opt, model)
        grads, aux = _sync(grads, detach_tree(aux), mesh)
        opt.step(grads)
        return aux, detach_tree(new_dpb)

    return step


def _mean_aux(auxes):
    if len(auxes) == 1:
        return auxes[0]
    return FrameAux(*[(a0 + torch.stack(rest).sum(0)) / len(auxes)
                      for a0, *rest in zip(*auxes)])


def make_cascade_step(model, opt, stage, *, lambdas, dist_lambda, pl_lambda,
                      pl_fn=None, remat=True, compute_dtype=None,
                      accum_steps: int = 1, mesh=None):
    """Whole-chain gradient step of the 'cascade' strategy:
    step(xs, targets, dpb0, noises) -> (FrameAux, last DPB), detached; xs
    and targets (p_frames, N, H, W, 3), noises as draw_cascade_noise makes
    them (or None: no noise). Rows are anchor-cycled (row i = replica
    i // A, anchor i % A); with accum_steps G, group g takes anchors
    [g A/G, (g+1) A/G) of every replica."""
    lam = _lambdas(model, lambdas)
    p_frames = stage.p_frames
    n_anchors = lam.shape[0]
    if accum_steps > 1 and n_anchors % accum_steps:
        raise ValueError(f"GRAD_ACCUM_STEPS={accum_steps} must divide the "
                         f"{n_anchors} rate anchors")
    mb = n_anchors // accum_steps

    def one_frame(x, target, dpb, noise, anchor_start, is_first_p):
        _, (aux, new_dpb) = frame_loss(
            model, x, target, dpb, lambdas=lam, dist_lambda=dist_lambda,
            pl_lambda=pl_lambda, loss_rate_keys=stage.loss_rate_keys,
            loss_dist_key=stage.loss_dist_key, pl_fn=pl_fn, noise=noise,
            is_first_p=is_first_p, compute_dtype=compute_dtype,
            anchor_start=anchor_start,
            anchor_count=mb if anchor_start is not None else None)
        return aux, new_dpb

    def frame(x, target, dpb, noise, anchor_start, is_first_p):
        if not remat:
            return one_frame(x, target, dpb, noise, anchor_start, is_first_p)
        # the recompute runs in backward, maybe on autograd's device
        # thread: switch whole-batch convs on there too, as every step
        # runs its chain inside whole_batch()
        return checkpoint(
            one_frame, x, target, dpb, noise, anchor_start, is_first_p,
            use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(),
                                rowwise.whole_batch()))

    def chain_loss(xs, targets, dpb, noises, anchor_start=None):
        auxes = []
        for k in range(p_frames):
            aux, dpb = frame(xs[k], targets[k], dpb,
                             None if noises is None else noises[k],
                             anchor_start, k == 0)
            auxes.append(aux)
        mean_aux = _mean_aux(auxes)
        return mean_aux.loss.mean(), (mean_aux, dpb)

    if accum_steps == 1:
        def step(xs, targets, dpb0, noises):
            with rowwise.whole_batch():
                loss, (aux, dpb) = chain_loss(xs, targets, dpb0, noises)
                grads = _grads(loss, opt, model)
            grads, aux = _sync(grads, detach_tree(aux), mesh)
            opt.step(grads)
            return aux, detach_tree(dpb)

        return step

    G = accum_steps

    def step(xs, targets, dpb0, noises):
        n = xs.shape[1]
        k = n // n_anchors  # replicas of the anchor cycle
        acc = None
        auxs, parts = [], []
        for g in range(G):
            rows = torch.tensor([r * n_anchors + g * mb + j for r in range(k)
                                 for j in range(mb)], device=xs.device)
            dpb_g = {key: v.index_select(0, rows) for key, v in dpb0.items()}
            with rowwise.whole_batch():
                loss, (aux, dpb) = chain_loss(
                    xs.index_select(1, rows), targets.index_select(1, rows),
                    dpb_g, None if noises is None else noises[g], g * mb)
                if opt.sharded:
                    # backward() sums the groups' gradients in .grad;
                    # fully_shard reduces them after the last group only
                    model.set_requires_gradient_sync(g == G - 1)
                    loss.backward()
                else:
                    grads = _grads(loss, opt, model)
                    acc = grads if acc is None else {
                        name: (a if b is None else b if a is None else a + b)
                        for (name, a), b in zip(acc.items(), grads.values())}
            auxs.append(detach_tree(aux))
            parts.append((rows, detach_tree(dpb)))
        if opt.sharded:
            acc = _take_grads(model, opt)
        # groups are contiguous anchor blocks: concatenated, anchor order
        aux = FrameAux(*[torch.cat(f) for f in zip(*auxs)])
        acc, aux = _sync(acc, aux, mesh)
        opt.step({name: None if v is None else v / G
                  for name, v in acc.items()})
        dpb = {}
        for key in parts[0][1]:
            like = parts[0][1][key]
            out = like.new_empty((n, *like.shape[1:]))
            for rows, d in parts:
                out[rows] = d[key]
            dpb[key] = out
        return aux, dpb

    return step


def to_f32(v, device) -> torch.Tensor:
    """An array or tensor of frames as an f32 tensor on `device`."""
    if isinstance(v, torch.Tensor):
        return v.to(device, torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def run_single_sequence(model, step_fn, inputs, targets, stage,
                        generator: torch.Generator, i_frame_fn=None,
                        sample_cb=None, mesh=None):
    """The reference's forward_single outer loops: for each subsequence
    start t_i, a fresh DPB from frame t_i (or i_frame_fn of it), then
    `p_frames` per-frame gradient steps. inputs/targets (N, T, H, W, 3)
    arrays or tensors (this rank's rows, with `mesh`). Returns the list of
    FrameAux."""
    dev = _device(model)
    t = inputs.shape[1]
    aux_list = []
    for t_i in range(t - stage.p_frames):
        ref = (i_frame_fn(inputs[:, t_i]) if i_frame_fn is not None
               else inputs[:, t_i])
        dpb = make_dpb(to_f32(ref, dev), model.channel_N, model.channel_M)
        for p_idx in range(stage.p_frames):
            x = to_f32(inputs[:, t_i + 1 + p_idx], dev)
            target = to_f32(targets[:, t_i + 1 + p_idx], dev)
            aux, dpb = step_fn(x, target, dpb,
                               draw_noise(model, x, generator, mesh),
                               p_idx == 0)
            aux_list.append(aux)
            if sample_cb is not None:
                sample_cb(aux, targets[:, t_i + 1 + p_idx], dpb["ref_frame"])
    return aux_list


def run_cascade_sequence(model, step_fn, inputs, targets, stage,
                         generator: torch.Generator, accum_steps: int = 1,
                         i_frame_fn=None, sample_cb=None, mesh=None):
    """forward_cascade's outer loop: one whole-chain gradient step per
    subsequence start. Returns the list of FrameAux."""
    dev = _device(model)
    t = inputs.shape[1]
    p_frames = stage.p_frames
    aux_list = []
    for t_i in range(t - p_frames):
        ref = (i_frame_fn(inputs[:, t_i]) if i_frame_fn is not None
               else inputs[:, t_i])
        dpb = make_dpb(to_f32(ref, dev), model.channel_N, model.channel_M)
        xs = torch.stack([to_f32(inputs[:, t_i + 1 + k], dev)
                          for k in range(p_frames)])
        ts = torch.stack([to_f32(targets[:, t_i + 1 + k], dev)
                          for k in range(p_frames)])
        noises = draw_cascade_noise(model, xs, generator, accum_steps, mesh)
        aux, dpb = step_fn(xs, ts, dpb, noises)
        aux_list.append(aux)
        if sample_cb is not None:
            sample_cb(aux, targets[:, t_i + p_frames], dpb["ref_frame"])
    return aux_list
