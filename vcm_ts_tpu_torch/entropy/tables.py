"""Quantized-CDF table containers shared by the host rANS coder.

Equivalent of the reference's CdfHelper + EntropyCoder.pmf_to_cdf
(DCVC_HEM/src/entropy_models/entropy_models.py:24-32,76-91): per-index CDF
rows, row sizes and symbol offsets, in the exact layout the native coder
consumes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .rans import pmf_to_quantized_cdf

PRECISION = 16


@dataclasses.dataclass(frozen=True)
class CdfTable:
    cdf: np.ndarray      # (n_cdfs, max_len) int32, zero-padded rows
    sizes: np.ndarray    # (n_cdfs,) int32 — valid entries per row
    offsets: np.ndarray  # (n_cdfs,) int32 — symbol offset per row

    @property
    def n(self) -> int:
        return int(self.cdf.shape[0])


def build_cdf_table(pmfs: np.ndarray, tail_mass: np.ndarray,
                    pmf_lengths: np.ndarray, offsets: np.ndarray) -> CdfTable:
    """Quantize per-row PMFs (+ tail escape mass) into a packed CdfTable.

    pmfs: (n, max_len) float; row i uses its first pmf_lengths[i] entries.
    tail_mass: (n,) float — probability assigned to the escape symbol.
    """
    pmfs = np.asarray(pmfs, dtype=np.float32)
    tail_mass = np.asarray(tail_mass, dtype=np.float32).reshape(-1)
    pmf_lengths = np.asarray(pmf_lengths, dtype=np.int32).reshape(-1)
    offsets = np.asarray(offsets, dtype=np.int32).reshape(-1)

    n = pmfs.shape[0]
    max_len = int(pmf_lengths.max())
    cdf = np.zeros((n, max_len + 2), dtype=np.int32)
    for i in range(n):
        row_pmf = np.concatenate([pmfs[i, :pmf_lengths[i]], tail_mass[i:i + 1]])
        row_cdf = pmf_to_quantized_cdf(row_pmf, PRECISION)
        cdf[i, :row_cdf.size] = row_cdf
    sizes = (pmf_lengths + 2).astype(np.int32)
    return CdfTable(cdf=cdf, sizes=sizes, offsets=offsets)
