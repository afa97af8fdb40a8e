"""Learned factorized prior over hyper-latents z.

Counterpart of vcm_ts_tpu/entropy/bit_estimator.py: four stacked monotone
layers give a per-channel CDF. For real coding `build_table` scans a +/-50
symbol range and quantizes per-channel CDF rows for the host rANS coder.

The quantized table is part of the stream format. `build_table` therefore
always evaluates the CDF on the CPU in f32 torch, on (K, C) grids, exactly
as the JAX package's `_torch_cdf_fn` does, wherever the model lives: GPU
transcendentals differ by about one ulp and would flip quantized counts.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .tables import CdfTable, build_cdf_table


class Bitparm(nn.Module):
    """One monotone CDF layer; parameters (1, C, 1, 1)."""

    def __init__(self, channel: int, final: bool = False):
        super().__init__()
        self.h = nn.Parameter(torch.zeros(1, channel, 1, 1))
        self.b = nn.Parameter(torch.zeros(1, channel, 1, 1))
        self.a = None if final else nn.Parameter(torch.zeros(1, channel, 1, 1))

    def forward(self, x):
        x = x * F.softplus(self.h) + self.b
        if self.a is None:
            return x
        return x + torch.tanh(x) * torch.tanh(self.a)


class BitEstimator(nn.Module):
    """Factorized-prior CDF model over NCHW tensors."""

    def __init__(self, channel: int):
        super().__init__()
        self.channel = channel
        self.f1 = Bitparm(channel)
        self.f2 = Bitparm(channel)
        self.f3 = Bitparm(channel)
        self.f4 = Bitparm(channel, final=True)

    def forward(self, x):
        return torch.sigmoid(self.f4(self.f3(self.f2(self.f1(x)))))


def build_indexes(shape) -> np.ndarray:
    """Channel-id index plane for an NHWC shape (N, H, W, C)."""
    n, h, w, c = shape
    return np.broadcast_to(
        np.arange(c, dtype=np.int32)[None, None, None, :], (n, h, w, c))


def _cpu_cdf_fn(model: BitEstimator):
    """(..., C) numpy f32 -> (..., C) numpy f32, in f32 torch on the CPU."""
    layers = []
    for f in (model.f1, model.f2, model.f3, model.f4):
        def t(p):
            return p.detach().to("cpu", torch.float32).reshape(-1).clone()
        layers.append((t(f.h), t(f.b), None if f.a is None else t(f.a)))

    def cdf(x_np):
        with torch.no_grad():
            x = torch.from_numpy(np.ascontiguousarray(x_np, dtype=np.float32))
            for h, b, a in layers:
                x = x * F.softplus(h) + b
                if a is not None:
                    x = x + torch.tanh(x) * torch.tanh(a)
            return torch.sigmoid(x).numpy()

    return cdf


def build_table(model: BitEstimator, search_range: int = 50) -> CdfTable:
    """Quantized per-channel CDF rows (the reference's BitEstimator.update).

    Per channel, finds the tightest [-minima, maxima] window whose CDF mass
    covers [1e-4, 0.9999] among integer symbols in [-R, R], then quantizes
    the windowed PMF plus the escape tail."""
    c = model.channel
    torch_cdf = _cpu_cdf_fn(model)

    def cdf_at(v):  # (K,) -> (K, C)
        v = np.asarray(v, dtype=np.float32)
        return torch_cdf(np.broadcast_to(v[:, None], (v.shape[0], c)))

    def cdf_grid(s):  # (C, K) -> (C, K)
        return torch_cdf(np.asarray(s, dtype=np.float32).T).T

    ints = np.arange(-search_range, search_range + 1, dtype=np.float32)
    probs = np.asarray(cdf_at(ints))  # (2R+1, C)

    idx = np.arange(2, search_range + 1)
    # minima: smallest i in [2, R] with cdf(-i) < 1e-4, else R
    ok = probs[search_range - idx, :] < 1e-4
    minima = np.where(ok.any(axis=0), idx[ok.argmax(axis=0)], search_range)
    # maxima: smallest i in [2, R] with cdf(i) > 0.9999, else R
    ok = probs[search_range + idx, :] > 0.9999
    maxima = np.where(ok.any(axis=0), idx[ok.argmax(axis=0)], search_range)

    minima = minima.astype(np.int32)
    maxima = maxima.astype(np.int32)
    pmf_start = (-minima).astype(np.float32)
    pmf_length = maxima + minima + 1
    max_length = int(pmf_length.max())

    samples = pmf_start[:, None] + np.arange(max_length,
                                             dtype=np.float32)[None, :]
    lower = np.asarray(cdf_grid(samples - 0.5))
    upper = np.asarray(cdf_grid(samples + 0.5))
    pmf = upper - lower
    # escape mass: left of the window plus right of the *global* last sample
    # (reference quirk kept: column -1, not per-row ends)
    tail_mass = lower[:, 0] + (1.0 - upper[:, -1])
    return build_cdf_table(pmf, tail_mass, pmf_length, -minima)
