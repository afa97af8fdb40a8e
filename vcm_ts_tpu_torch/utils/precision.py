"""Inference dtype policies: f32, bf16, and mixed.

Counterpart of vcm_ts_tpu/utils/precision.py, with its own copy of the
module list. `cast_params_mixed` keeps the parameters of the
reconstruction-critical modules (and the quantization-scale scalars) in f32
and casts everything else to bf16. The port's convs and linears compute in
the promoted dtype of their input and their weights (ops/layers.py), as
flax's do, so a bf16 activation entering an f32 module runs and comes out
in f32, and an f32 activation stays f32 through bf16 modules.

Both casts work in place on the module's parameters and return the module.
SubpelConv's k-major weight cache is keyed on the weights' storage and
dtype, so it refreshes after a cast.

Training's mixed precision (`cast_for_compute`, the port's copy of
vcm_ts_tpu/train/train_step.py:57-72) does not cast in place: it returns
bf16 copies of the f32 master parameters for torch.func.functional_call,
made inside the loss, so that the gradients flow back into f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

# Decode-side reconstruction path of the DMC (models/dmc.py): everything
# from the decoded latents and contexts to x_hat, the recurrent feature
# feedback producers, and the q-scale scalars (index-derivation inputs).
RECON_F32_MODULES = (
    "recon_generation_net",
    "contextual_decoder",
    "context_fusion_net",
    "feature_extractor",
    "feature_adaptor_I",
    "feature_adaptor_P",
    "mv_decoder",
    "mv_y_q_scale",
    "y_q_scale",
    "mv_y_q_basic",
    "y_q_basic",
)


@torch.no_grad()
def cast_params(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every f32 parameter to `dtype` (the bench's bf16 mode)."""
    for p in module.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(dtype)
    return module


@torch.no_grad()
def cast_params_mixed(module: nn.Module,
                      keep_f32=RECON_F32_MODULES) -> nn.Module:
    """Cast f32 parameters to bf16, except those whose dotted name has a
    component in `keep_f32` (matched at any depth, so one list serves the
    DMC and IntraNoAR)."""
    keep = set(keep_f32)
    for name, p in module.named_parameters():
        if p.dtype == torch.float32 and not keep & set(name.split(".")):
            p.data = p.data.to(torch.bfloat16)
    return module


# Parameters that stay f32 in training's bf16 compute (a substring of the
# dotted name): the factorized bit estimators' CDF layers shape
# likelihoods through nested sigmoids, and they are tiny.
MP_KEEP_F32 = ("bit_estimator",)


def cast_for_compute(module: nn.Module, dtype: torch.dtype) -> dict:
    """{name: parameter or its differentiable `dtype` copy} for
    torch.func.functional_call: every f32 parameter whose name contains
    none of MP_KEEP_F32 is cast; the masters are untouched."""
    return {name: p.to(dtype) if p.dtype == torch.float32
            and not any(k in name for k in MP_KEEP_F32) else p
            for name, p in module.named_parameters()}
