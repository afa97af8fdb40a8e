"""Scale-indexed Gaussian/Laplace conditional coder.

Counterpart of vcm_ts_tpu/entropy/gaussian.py: a 256-level log-spaced scale
table; predicted sigmas map to table rows on the device (`build_indexes`),
and the per-row quantized CDFs, a format constant shipped in
data/gaussian_cdf.npz, drive the host rANS coder.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .tables import CdfTable, build_cdf_table

_SHIPPED = os.path.join(os.path.dirname(__file__), "data", "gaussian_cdf.npz")
_shipped_cache: dict = {}


def _load_shipped(distribution: str) -> CdfTable | None:
    if distribution in _shipped_cache:
        return _shipped_cache[distribution]
    table = None
    if os.path.exists(_SHIPPED):
        with np.load(_SHIPPED) as z:
            table = CdfTable(
                cdf=z[f"{distribution}_cdf"].copy(),
                sizes=z[f"{distribution}_sizes"].copy(),
                offsets=z[f"{distribution}_offsets"].copy())
    _shipped_cache[distribution] = table
    return table


class GaussianCoder:
    def __init__(self, distribution: str = "laplace"):
        if distribution not in ("laplace", "gaussian"):
            raise ValueError(f"unknown distribution {distribution!r}")
        self.distribution = distribution
        if distribution == "laplace":
            self.scale_min, self.scale_max, self.levels = 0.01, 64.0, 256
        else:
            self.scale_min, self.scale_max, self.levels = 0.11, 64.0, 256
        self.log_scale_min = math.log(self.scale_min)
        self.log_scale_max = math.log(self.scale_max)
        self.log_scale_step = (
            (self.log_scale_max - self.log_scale_min) / (self.levels - 1))
        self.scale_table = np.exp(np.linspace(
            self.log_scale_min, self.log_scale_max, self.levels)).astype(np.float64)

    # ---------------------------------------------------------------- device
    def build_indexes(self, scales: torch.Tensor) -> torch.Tensor:
        """Map predicted sigma -> scale-table row, as gaussian.py:55-60:
        max(s, 1e-5), log, minus and over the table's f32 constants, clip,
        truncate, all in the scales' dtype: bf16 scales index in bf16, the
        constants rounded to bf16, as JAX's weak-typed floats are."""
        def const(v):  # made on the device: no host wait
            return torch.full((), float(np.float32(v)), dtype=torch.float32,
                              device=scales.device).to(scales.dtype)

        lmin = const(self.log_scale_min)
        step = const(self.log_scale_step)
        scales = torch.clamp_min(scales, 1e-5)
        indexes = (torch.log(scales) - lmin) / step
        return torch.clamp(indexes, 0, self.levels - 1).to(torch.int32)

    # ------------------------------------------------------------------ host
    def _cdf(self, x, scale):
        if self.distribution == "laplace":
            return 0.5 - 0.5 * np.sign(x) * np.expm1(-np.abs(x) / scale)
        from scipy.special import erf
        return 0.5 * (1.0 + erf(x / (scale * math.sqrt(2.0))))

    def build_table(self, search_range: int = 50) -> CdfTable:
        """Quantized CDF rows per scale level: the shipped format constant
        (pinned to torch-f32 arithmetic) when available, else an analytic
        numpy rebuild that is self-consistent but not byte-interoperable
        with streams coded against the shipped table."""
        if search_range == 50:
            shipped = _load_shipped(self.distribution)
            if shipped is not None:
                return shipped
        scales = self.scale_table
        idx = np.arange(2, search_range + 1)
        probs = self._cdf(idx[:, None].astype(np.float64), scales[None, :])
        ok = probs > 0.9999
        center = np.where(ok.any(axis=0), idx[ok.argmax(axis=0)], search_range)
        center = center.astype(np.int32)

        pmf_length = 2 * center + 1
        max_length = int(pmf_length.max())
        samples = (np.arange(max_length, dtype=np.float64)[None, :]
                   - center[:, None])
        upper = self._cdf(samples + 0.5, scales[:, None])
        lower = self._cdf(samples - 0.5, scales[:, None])
        pmf = (upper - lower).astype(np.float32)
        tail_mass = (2.0 * lower[:, 0]).astype(np.float32)
        return build_cdf_table(pmf, tail_mass, pmf_length, -center)
