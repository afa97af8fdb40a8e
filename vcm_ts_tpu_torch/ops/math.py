"""Scalar/elementwise primitives of the codec (inference forms).

Counterpart of vcm_ts_tpu/ops/math.py. The JAX package gives `lower_bound`
a custom VJP and `quant_ste` a straight-through gradient for training;
this port runs inference only, so both are their forward values here.
"""

from __future__ import annotations

import math

import torch

_LOG2 = math.log(2.0)


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    return torch.clamp_min(x, bound)


def quant_round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, as jnp.round."""
    return torch.round(x)


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
