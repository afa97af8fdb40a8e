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
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..parallel.mesh import full_tensor

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

    def __init__(self, model: nn.Module, mask: dict, lr: float,
                 grad_clip_norm: float = 0.0):
        self.params = {n: p for n, p in model.named_parameters()
                       if mask[n]}
        self.lr, self.grad_clip_norm = lr, grad_clip_norm
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}

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
        so the norm is one plain value on every rank."""
        shards = [g for g in grads if _is_dtensor(g)]
        if shards:
            sq = sum(torch.sum(g.to_local() * g.to_local()) for g in shards)
            dist.all_reduce(sq, group=shards[0].device_mesh.get_group())
            sq = sq + sum(torch.sum(g * g) for g in grads
                          if not _is_dtensor(g))
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
            return {n: full_tensor(t).detach().cpu().clone()
                    for n, t in d.items()}

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
                mine.copy_(_like(mine, whole))
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
        c1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(t))
        c2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(t))
        mu, nu = list(self.mu.values()), list(self.nu.values())
        kinds = [_is_dtensor(p) for p in ps]
        for kind in sorted(set(kinds)):
            pick = [i for i, k in enumerate(kinds) if k == kind]
            self._adamw(*([v[i] for i in pick] for v in (ps, gs, mu, nu)),
                        c1, c2)

    def _adamw(self, ps, gs, mu, nu, c1, c2) -> None:
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, torch._foreach_mul(gs, 1.0 - B1))
        g2 = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(g2, 1.0 - B2)
        torch._foreach_mul_(nu, B2)
        torch._foreach_add_(nu, g2)
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        u = torch._foreach_div(mu, c1)
        torch._foreach_div_(u, den)
        torch._foreach_add_(u, torch._foreach_mul(ps, WEIGHT_DECAY))
        torch._foreach_mul_(u, -self.lr)
        torch._foreach_add_(ps, u)


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
