"""The stage optimizer: AdamW over the trainable parameters of a stage.

The port's copy of vcm_ts_tpu/train/optimizer.py. `trainable_mask` decides
per parameter from its top-level module name (the reference's
DCVC_HEM.activate_modules_* groups). `StageOptimizer` is optax's
`adamw(lr, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.01)` written out, in
optax's order of operations, so that it rounds as optax does:
    mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  t += 1
    u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p
    p = p + (-lr) u
(torch.optim.AdamW decays and steps in another order, a few ulp apart).
Each operation runs on all parameters at once (torch._foreach_*), a few
launches on the card instead of one per parameter. `clip_by_global_norm`
runs before it when grad_clip_norm > 0 (the norm over the trainable
parameters only, as optax's multi_transform applies the chain to them
alone). A frozen parameter gets a zero update: no moments, no decay
(optax's set_to_zero), so it stays bit-identical. Moments are fresh for
each stage (`make_stage_optimizer`).

Under FSDP (parallel/tensor.shard_params_fsdp, before the optimizer is
built) the parameters, their gradients and the moments are DTensor shards,
except the few the step reads outside the forward, which stay whole: each
operation then runs once on the shards and once on the whole tensors
(torch's foreach ops take no mixed lists), the global norm is one value on
every rank, and `state_dict` / `load_state_dict` gather and split whole
moments (collectives every rank joins).

Under tensor parallelism (parallel/tensor.shard_params_tp, before the
optimizer is built) a split parameter is the rank's slice of the whole
tensor, and its moments are slices too. The global norm sums the split
gradients' squares over the model group and adds the whole parameters'
once (their gradients are equal on the model ranks), so it is the norm
over the whole tree. `state_dict` gathers every split moment whole, in
model-rank order (a collective of the model group), and `load_state_dict`
takes the rank's slice of a whole moment.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..parallel.mesh import full_tensor
from ..parallel.tensor import gather_whole, own_slice, split_params

# Top-level DMC parameter groups (the reference's dcvc_hem.py:23-42)
INTER_DIST_MODULES = frozenset({
    "bit_estimator_z_mv",
    "mv_decoder",
    "mv_encoder",
    "mv_hyper_prior_decoder",
    "mv_hyper_prior_encoder",
    "mv_y_spatial_prior",
    "mv_y_prior_fusion",
    "optic_flow",
})
INTER_RATE_PARAMS = frozenset({"mv_y_q_basic", "mv_y_q_scale"})
RECON_RATE_PARAMS = frozenset({"y_q_basic", "y_q_scale"})
MODES = ("inter_dist", "inter_dist_rate", "recon_dist", "recon_dist_rate",
         "all")
# optax.adamw's settings in the JAX package (the reference's torch AdamW)
B1 = 0.9
B2 = 0.99
EPS = 1e-8
WEIGHT_DECAY = 0.01


def _trainable(top: str, mode: str) -> bool:
    in_inter = top in INTER_DIST_MODULES
    in_inter_rate = top in INTER_RATE_PARAMS
    in_recon_rate = top in RECON_RATE_PARAMS
    if mode == "inter_dist":
        return in_inter
    if mode == "inter_dist_rate":
        return in_inter or in_inter_rate
    if mode == "recon_dist":
        return not (in_inter or in_inter_rate or in_recon_rate)
    if mode == "recon_dist_rate":
        return not (in_inter or in_inter_rate)
    if mode == "all":
        return True
    raise ValueError(f"unknown trainable mode: {mode}")


def trainable_mask(model: nn.Module, mode: str) -> dict:
    """{parameter name: True where trainable under `mode`}."""
    return {name: _trainable(name.split(".")[0], mode)
            for name, _ in model.named_parameters()}


class StageOptimizer:
    """Masked AdamW (optax's formulas) over a model's parameters, updated
    in place from a {name: gradient} dict."""

    b1, b2, eps, weight_decay = B1, B2, EPS, WEIGHT_DECAY

    def __init__(self, model: nn.Module, mask: dict, lr: float,
                 grad_clip_norm: float = 0.0):
        self.params = {n: p for n, p in model.named_parameters()
                       if mask[n]}
        self.lr, self.grad_clip_norm = lr, grad_clip_norm
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        # {name: ModelAxis} of the tensor-parallel slices among them
        split = split_params(model)
        self.split = {n: split[n] for n in self.params if n in split}

    @property
    def names(self):
        """The trainable parameters' names, in the model's order."""
        return list(self.params)

    @property
    def sharded(self) -> bool:
        """Whether FSDP shards the parameters (DTensors)."""
        return any(_is_dtensor(p) for p in self.params.values())

    def _clip(self, grads: list) -> list:
        """optax.clip_by_global_norm: g / norm * max where norm >= max.
        Under FSDP the shards' squares are summed here and all-reduced,
        under tensor parallelism the slices' over the model group, so the
        norm is one plain value on every rank."""
        shards = [g for g in grads if _is_dtensor(g)]
        split = [n in self.split for n in self.params]
        if shards:
            sq = sum(torch.sum(g.to_local() * g.to_local()) for g in shards)
            dist.all_reduce(sq, group=shards[0].device_mesh.get_group())
            sq = sq + sum(torch.sum(g * g) for g in grads
                          if not _is_dtensor(g))
        elif any(split):
            sq = sum(torch.sum(g * g) for g, s in zip(grads, split) if s)
            dist.all_reduce(sq, group=next(iter(self.split.values())).group)
            sq = sq + sum(torch.sum(g * g) for g, s in zip(grads, split)
                          if not s)
        else:
            sq = sum(torch.sum(g * g) for g in grads)
        norm = torch.sqrt(sq)
        keep = norm < self.grad_clip_norm
        return [torch.where(keep, g, g / norm.to(g.dtype)
                            * self.grad_clip_norm) for g in grads]

    def state_dict(self) -> dict:
        """The step count and both moments, on the CPU (a checkpoint's
        "opt_state")."""
        def host(d):
            return {n: gather_whole(full_tensor(t), self.split.get(n))
                    .detach().cpu().clone() for n, t in d.items()}

        return {"count": self.count, "mu": host(self.mu), "nu": host(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore state_dict(); the trainable parameters must be the same
        (a stage with another mask raises ValueError)."""
        if set(state["mu"]) != set(self.mu) or set(state["nu"]) != set(
                self.nu):
            raise ValueError("optimizer state is for other trainable "
                             "parameters than this stage's")
        for n in self.mu:
            for mine, whole in ((self.mu[n], state["mu"][n]),
                                (self.nu[n], state["nu"][n])):
                mine.copy_(_like(mine, own_slice(whole, self.split.get(n))))
        self.count = int(state["count"])

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        """One update from grads[name] (a tensor, or None for no gradient:
        treated as zeros) of every trainable parameter."""
        ps = list(self.params.values())
        gs = [torch.zeros_like(p) if grads.get(n) is None else grads[n]
              for n, p in self.params.items()]
        if self.grad_clip_norm > 0:
            gs = self._clip(gs)
        self.count += 1
        t = self.count
        # optax's bias corrections, computed in f32 as it computes them
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(t))
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(t))
        mu, nu = list(self.mu.values()), list(self.nu.values())
        kinds = [_is_dtensor(p) for p in ps]
        for kind in sorted(set(kinds)):
            pick = [i for i, k in enumerate(kinds) if k == kind]
            self._adamw(*([v[i] for i in pick] for v in (ps, gs, mu, nu)),
                        c1, c2)

    def _adamw(self, ps, gs, mu, nu, c1, c2) -> None:
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(gs, 1.0 - b1))
        g2 = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(g2, 1.0 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(mu, c1)
        torch._foreach_div_(u, den)
        torch._foreach_add_(u, torch._foreach_mul(ps, self.weight_decay))
        torch._foreach_mul_(u, -self.lr)
        torch._foreach_add_(ps, u)


class AdamW(StageOptimizer):
    """optax.chain(clip_by_global_norm(grad_clip_norm), adamw(lr,
    weight_decay=weight_decay)) with optax's other defaults (b1 0.9, b2
    0.999, eps 1e-8), as the detector and OCR trainers use it: over every
    parameter of the model that requires a gradient, each decayed. `lr` is
    a float or a schedule (optax's: the step count before the update ->
    the rate), evaluated in float32. The codec's StageOptimizer keeps its
    own settings (b2 0.99, weight decay 0.01)."""

    b2 = 0.999

    def __init__(self, model: nn.Module, lr, weight_decay: float = 1e-4,
                 grad_clip_norm: float = 0.0):
        super().__init__(model, {n: p.requires_grad
                                 for n, p in model.named_parameters()},
                         0.0, grad_clip_norm)
        self.schedule = lr if callable(lr) else (lambda count: lr)
        self.weight_decay = weight_decay

    def step(self, grads: dict) -> None:
        self.lr = float(np.float32(self.schedule(self.count)))
        super().step(grads)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule (exponent 1): linear from
    init_value to peak_value over warmup_steps, then cosine decay to
    end_value at decay_steps; float32 arithmetic in optax's order."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            c = min(max(count, 0), warmup_steps)
            frac = f32(1) - f32(c) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac
                         + f32(peak_value))
        c = f32(min(count - warmup_steps, cos_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c
                                             / f32(cos_steps)))
        return float(f32(peak_value) * (f32(1 - alpha) * cosine
                                         + f32(alpha)))

    return schedule


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _like(mine: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """`whole` (a host tensor) on mine's device, split as mine is."""
    whole = whole.to(mine.device, mine.dtype)
    if not _is_dtensor(mine):
        return whole
    from torch.distributed.tensor import distribute_tensor

    # every rank holds the whole tensor: take this rank's shard, no
    # communication
    return distribute_tensor(whole, mine.device_mesh, mine.placements,
                             src_data_rank=None)


def make_stage_optimizer(model: nn.Module, mode: str, lr: float,
                         grad_clip_norm: float = 0.0) -> StageOptimizer:
    """A stage's optimizer, with fresh moments (the reference re-inits at
    each stage boundary)."""
    return StageOptimizer(model, trainable_mask(model, mode), lr,
                          grad_clip_norm)
