"""Generate the shipped scale-table CDF constants of the port's
GaussianCoder: the port's counterpart of the JAX package's
tools/gen_gaussian_tables.py.

    python -m vcm_ts_tpu_torch.gen_gaussian_tables [--out PATH]

The quantized-CDF rows of the scale-indexed Gaussian/Laplace coder are
weight-independent: a pure function of the 256-level scale table and the
distribution, i.e. a bitstream-format constant. The reference ecosystem
defines it through torch float32 arithmetic on the CPU
(DCVC_HEM/src/entropy_models/entropy_models.py:224-262): f32
linspace/exp for the scale table and f32 Laplace/Normal CDF evaluation
(torch's CPU expm1/erf, which numpy cannot reproduce bit for bit: a
handful of quantized counts would flip and desync the rANS decode).

So this tool always computes on the CPU, whatever device the rest of the
port runs on, and launches nothing on a card: the constant is what
torch's CPU f32 arithmetic gives. Quantization goes through the port's
entropy/tables.build_cdf_table. It writes only the port's copy,
vcm_ts_tpu_torch/entropy/data/gaussian_cdf.npz (or --out), which
entropy/gaussian.py loads, and refuses any path inside the JAX package
vcm_ts_tpu/.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from .entropy.tables import build_cdf_table

SEARCH_RANGE = 50
_PKG = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(_PKG, "entropy", "data", "gaussian_cdf.npz")
JAX_PACKAGE = os.path.join(os.path.dirname(_PKG), "vcm_ts_tpu")

SPECS = {
    # distribution -> (scale_min, scale_max, levels)
    "laplace": (0.01, 64.0, 256),
    "gaussian": (0.11, 64.0, 256),
}


def _dist(name: str, scales: torch.Tensor):
    if name == "laplace":
        return torch.distributions.laplace.Laplace(
            torch.zeros_like(scales), scales)
    return torch.distributions.normal.Normal(
        torch.zeros_like(scales), scales)


def build(name: str):
    """The CdfTable of one distribution, from f32 tensors on the CPU."""
    smin, smax, levels = SPECS[name]
    # f32 scale table, exactly as the ecosystem defines it
    scale_table = torch.exp(
        torch.linspace(math.log(smin), math.log(smax), levels,
                       device="cpu"))

    # per-row symbol window: smallest i in [2, R] with cdf(i) > 0.9999
    center = torch.full_like(scale_table, SEARCH_RANGE)
    d = _dist(name, scale_table)
    for i in range(SEARCH_RANGE, 1, -1):
        probs = d.cdf(torch.full_like(scale_table, float(i)))
        center = torch.where(probs > 0.9999, torch.full_like(center, float(i)),
                             center)
    center = center.int()
    pmf_length = 2 * center + 1
    max_length = int(pmf_length.max())

    samples = (torch.arange(max_length) - center[:, None]).float()
    d = _dist(name, torch.zeros_like(samples) + scale_table[:, None])
    upper = d.cdf(samples + 0.5)
    lower = d.cdf(samples - 0.5)
    pmf = (upper - lower).numpy()
    tail_mass = (2.0 * lower[:, 0]).numpy()

    return build_cdf_table(pmf, tail_mass, pmf_length.numpy(),
                           (-center).numpy())


def check_out_path(path: str) -> str:
    """The absolute output path; raises for a path inside vcm_ts_tpu/
    (the JAX package keeps its own copy, which this tool never writes)."""
    out = os.path.realpath(path)
    jax_pkg = os.path.realpath(JAX_PACKAGE)
    if os.path.commonpath([out, jax_pkg]) == jax_pkg:
        raise ValueError(f"{path}: refusing to write inside the JAX "
                         f"package ({jax_pkg}); the port writes its own "
                         f"copy ({OUT})")
    return out


def tables() -> dict:
    """{<name>_cdf, <name>_sizes, <name>_offsets} for every distribution."""
    out = {}
    for name in SPECS:
        t = build(name)
        out[f"{name}_cdf"] = t.cdf
        out[f"{name}_sizes"] = t.sizes
        out[f"{name}_offsets"] = t.offsets
        print(f"{name}: cdf {t.cdf.shape}, max size {t.sizes.max()}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    a = ap.parse_args(argv)
    out = check_out_path(a.out)
    arrays = tables()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")
    return out


if __name__ == "__main__":
    main()
