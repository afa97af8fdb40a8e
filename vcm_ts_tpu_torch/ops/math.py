"""Scalar/elementwise primitives of the codec, with the JAX package's
gradient rules.

Counterpart of vcm_ts_tpu/ops/math.py:
- `lower_bound`: max(x, bound) with the custom VJP of the reference's
  LowerBound (the gradient passes where x >= bound or where it pushes x
  up); a plain clamp when no gradient is being recorded, so the codec's
  inference values are the same bits as before;
- `quant_ste`: round half to even with a straight-through gradient;
- `add_uniform_noise`: x + U(-0.5, 0.5), the noise passed in explicitly
  (torch's generators do not give jax.random's draws, so parity tests feed
  JAX's); `uniform_noise` draws it from a torch.Generator.
"""

from __future__ import annotations

import math

import torch

_LOG2 = math.log(2.0)


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _LowerBound.apply(x, bound)
    return torch.clamp_min(x, bound)


def quant_round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, as jnp.round."""
    return torch.round(x)


def quant_ste(x: torch.Tensor) -> torch.Tensor:
    """Round half to even; the gradient passes straight through."""
    return x + (torch.round(x) - x).detach()


def uniform_noise(shape, generator: torch.Generator, dtype=torch.float32,
                  device="cpu") -> torch.Tensor:
    """U(-0.5, 0.5) of `shape`, drawn from `generator` (on its device)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    return (u - 0.5).to(dtype)


def add_uniform_noise(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """x + noise, with no gradient to the noise (a U(-0.5, 0.5) draw)."""
    return x + noise.detach()


def probs_to_bits(probs: torch.Tensor) -> torch.Tensor:
    bits = -torch.log(probs + 1e-5) / _LOG2
    return lower_bound(bits, 0.0)


def laplace_cdf(x, scale):
    """CDF of Laplace(mu=0, b=scale)."""
    return 0.5 - 0.5 * torch.sign(x) * torch.expm1(-torch.abs(x) / scale)


def normal_cdf(x, scale):
    """CDF of Normal(mu=0, sigma=scale)."""
    return 0.5 * (1.0 + torch.erf(x / (scale * math.sqrt(2.0))))


def gaussian_bits(y, sigma):
    """Bit cost of y under quantized N(0, sigma)."""
    sigma = torch.clamp(sigma, 0.11, 1e10)
    probs = normal_cdf(y + 0.5, sigma) - normal_cdf(y - 0.5, sigma)
    return probs_to_bits(probs)


def laplace_bits(y, sigma):
    """Bit cost of y under quantized Laplace(0, sigma)."""
    sigma = torch.clamp(sigma, 1e-5, 1e10)
    probs = laplace_cdf(y + 0.5, sigma) - laplace_cdf(y - 0.5, sigma)
    return probs_to_bits(probs)
