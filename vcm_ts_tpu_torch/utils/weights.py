"""Carry weights into the port, and the port's own seeded init.

`state_dict_from_flax` is the port's copy of the JAX package's
utils/weight_export.py: it takes the JAX parameters as a nested dict of
numpy arrays and returns a state dict with the reference torch names,
which the port's modules load with strict=True:
- conv kernels HWIO -> OIHW, Dense kernels transposed;
- per-channel (1, 1, 1, C) vectors -> (1, C, 1, 1).

`init_params` draws the JAX package's default init with a torch.Generator:
Xavier-normal with gain sqrt(2) for conv and linear weights, bias 0.01,
N(0, 0.01) for the bit estimators, ones for the q parameters. Multiplying
every weight by `kernel_scale` = 0.5 gives the "damped" control on which
streams are compared byte for byte; `make_intra` and `make_dmc` build the
seeded damped models that the port's bench and chip_smoke.py drive (no
DMC or IntraNoAR checkpoint ships in the repo).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from ..entropy.bit_estimator import Bitparm


def state_dict_from_flax(params: dict) -> dict:
    """{"params": {...}} or the inner tree -> {name: torch.Tensor}."""
    inner = params.get("params", params)
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
                continue
            v = np.asarray(v)
            if k == "kernel":
                key = prefix + ".weight" if prefix else "weight"
                v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
            elif k == "bias":
                key = prefix + ".bias" if prefix else "bias"
            else:
                key = path
                if v.ndim == 4 and v.shape[:3] == (1, 1, 1):
                    v = v.transpose(0, 3, 1, 2)
            out[key] = torch.from_numpy(np.array(v, copy=True, order="C"))

    walk(inner, "")
    return out


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0,
                kernel_scale: float = 1.0) -> nn.Module:
    """Seeded init in place (the JAX package's defaults); returns model."""
    g = torch.Generator().manual_seed(seed)

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=g, dtype=torch.float32) * std)

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = m.weight
            rf = w[0, 0].numel() if w.dim() > 2 else 1
            fan_in, fan_out = w.shape[1] * rf, w.shape[0] * rf
            normal(w, math.sqrt(4.0 / (fan_in + fan_out)) * kernel_scale)
            if m.bias is not None:
                m.bias.fill_(0.01)
        elif isinstance(m, Bitparm):
            for p in (m.h, m.b, m.a):
                if p is not None:
                    normal(p, 0.01)
    return model


def make_intra(device="cuda") -> nn.Module:
    """IntraNoAR (N=192), seeded damped init (seed 0, every weight x 0.5)."""
    from ..models.intra import IntraNoAR

    return init_params(IntraNoAR(device=device), seed=0, kernel_scale=0.5)


def make_dmc(device="cuda", fast_warp: bool = False) -> nn.Module:
    """DMC (64/64/96, anchor_num 4), seeded damped init (seed 1, every
    weight x 0.5)."""
    from ..models.dmc import DMC

    return init_params(DMC(fast_warp=fast_warp, device=device), seed=1,
                       kernel_scale=0.5)
