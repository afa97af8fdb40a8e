"""Quantization and the two-step dual-spatial-prior (checkerboard) model.

Counterpart of vcm_ts_tpu/models/common.py, as functions over NHWC tensors
(channel dimension last, as in the JAX package): shared by the intra and
inter models and by the codec engines.

Design rule kept from the JAX package: the codec engines derive every
prior the stream depends on through the decoder's own stage functions
(`decompress_stage_a/b/c`, called from the models' decompress stages) and
quantize the encoder's latent against those buffers with
`encode_symbols_step0/1`; the written stream then decodes bit-exactly on
any frame chain.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.math import lower_bound, quant_round, quant_ste


def quant(x, training: bool = False):
    """Round half to even; in training with a straight-through gradient.
    The codec's stages call the eval form."""
    return quant_ste(x) if training else quant_round(x)


def checkerboard_masks(h: int, w: int, dtype=torch.float32, device="cpu",
                       row0: int = 0):
    """mask_0 is 1 where (y + x) is even, mask_1 its complement; both
    (1, H, W, 1) for NHWC broadcast. `row0`: the global row of the first
    row (a plane split by rows, parallel/spatial.py): the parity is the
    global row's."""
    ys = torch.arange(row0, row0 + h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    mask0 = ((ys + xs) % 2 == 0).to(dtype)[None, :, :, None]
    return mask0, 1.0 - mask0


def process_with_mask(y, scales, means, mask, training: bool = False):
    """One checkerboard half-step."""
    scales_hat = scales * mask
    means_hat = means * mask
    y_res = (y - means_hat) * mask
    y_q = quant(y_res, training)
    y_hat = y_q + means_hat
    return y_res, y_q, y_hat, scales_hat


class DualPriorForward(NamedTuple):
    y_res: torch.Tensor
    y_q: torch.Tensor
    y_hat: torch.Tensor
    scales_hat: torch.Tensor


def plane_row0(spatial, t) -> int:
    """The global row of NHWC plane t's first row: 0 unless `spatial` (a
    SpatialAxis, or None) splits it."""
    return 0 if spatial is None else spatial.row0(t, 1)


def plane_sum(spatial, t, nchw: bool = False):
    """Per row of N, the sum of a plane (NHWC, or NCHW with `nchw`) over
    the whole frame: over the ranks' rows too when `spatial` splits it."""
    if spatial is None:
        return torch.sum(t, dim=(1, 2, 3))
    return spatial.sum_plane(t.permute(0, 2, 3, 1) if nchw else t)


def _masks_like(t, row0: int = 0):
    _, h, w, _ = t.shape
    return checkerboard_masks(h, w, t.dtype, t.device, row0)


# Each function below takes `row0`, the global row of its planes' first
# row, for the masks of a plane split by rows (plane_row0).

def forward_dual_prior(y, means, scales, quant_step,
                       spatial_prior: Callable, *,
                       training: bool = False,
                       row0: int = 0) -> DualPriorForward:
    """Two-step dual-prior coding. `spatial_prior` maps the step-0 context
    (y_hat_0_0 | y_hat_1_1 | means | scales | quant_step), NHWC, to the
    4-way split (scales_0, means_0, scales_1, means_1) for step 1."""
    mask0, mask1 = _masks_like(y, row0)
    quant_step = lower_bound(quant_step, 0.5)
    y = y / quant_step
    y_0, y_1 = torch.chunk(y, 2, dim=-1)
    scales_0, scales_1 = torch.chunk(scales, 2, dim=-1)
    means_0, means_1 = torch.chunk(means, 2, dim=-1)

    y_res_0_0, y_q_0_0, y_hat_0_0, s_hat_0_0 = process_with_mask(
        y_0, scales_0, means_0, mask0, training)
    y_res_1_1, y_q_1_1, y_hat_1_1, s_hat_1_1 = process_with_mask(
        y_1, scales_1, means_1, mask1, training)

    params = torch.cat((y_hat_0_0, y_hat_1_1, means, scales, quant_step),
                       dim=-1)
    scales_0, means_0, scales_1, means_1 = torch.chunk(
        spatial_prior(params), 4, dim=-1)

    y_res_0_1, y_q_0_1, y_hat_0_1, s_hat_0_1 = process_with_mask(
        y_0, scales_0, means_0, mask1, training)
    y_res_1_0, y_q_1_0, y_hat_1_0, s_hat_1_0 = process_with_mask(
        y_1, scales_1, means_1, mask0, training)

    def join(a0, a1, b1, b0):
        return torch.cat((a0 + a1, b1 + b0), dim=-1)

    return DualPriorForward(
        y_res=join(y_res_0_0, y_res_0_1, y_res_1_1, y_res_1_0),
        y_q=join(y_q_0_0, y_q_0_1, y_q_1_1, y_q_1_0),
        y_hat=join(y_hat_0_0, y_hat_0_1, y_hat_1_1, y_hat_1_0) * quant_step,
        scales_hat=join(s_hat_0_0, s_hat_0_1, s_hat_1_1, s_hat_1_0))


# ---------------------------------------------------------------------------
# Encoder-side symbol quantization against the DECODER's prior buffers.
# ---------------------------------------------------------------------------

def encode_symbols_step0(y, means, quant_step, row0: int = 0):
    """Checkerboard step-0 symbols of latent `y` given stage-A buffers
    (means full width, quant_step already lower-bounded)."""
    mask0, mask1 = _masks_like(y, row0)
    y = y / quant_step
    y_0, y_1 = torch.chunk(y, 2, dim=-1)
    means_0, means_1 = torch.chunk(means, 2, dim=-1)
    q00 = quant_round((y_0 - means_0 * mask0) * mask0)
    q11 = quant_round((y_1 - means_1 * mask1) * mask1)
    return q00 + q11


def encode_symbols_step1(y, means_0, means_1, quant_step, row0: int = 0):
    """Checkerboard step-1 symbols given stage-B buffers (the means halves
    from the spatial prior)."""
    mask0, mask1 = _masks_like(y, row0)
    y = y / quant_step
    y_0, y_1 = torch.chunk(y, 2, dim=-1)
    q01 = quant_round((y_0 - means_0 * mask1) * mask1)
    q10 = quant_round((y_1 - means_1 * mask0) * mask0)
    return q01 + q10


# ---------------------------------------------------------------------------
# Decompress side, split into stages around the two host rANS reads. Stage A
# emits the step-0 coding scales; stage B consumes decoded step-0 symbols and
# emits step-1 scales; stage C consumes step-1 symbols and reassembles y_hat.
# ---------------------------------------------------------------------------

def decompress_stage_a(scales, quant_step, row0: int = 0):
    mask0, mask1 = _masks_like(scales, row0)
    quant_step = torch.clamp_min(quant_step, 0.5)
    scales_0, scales_1 = torch.chunk(scales, 2, dim=-1)
    return scales_0 * mask0 + scales_1 * mask1, quant_step


def decompress_stage_b(y_q_r_0, means, scales, quant_step,
                       spatial_prior: Callable, row0: int = 0):
    mask0, mask1 = _masks_like(means, row0)
    means_0, means_1 = torch.chunk(means, 2, dim=-1)
    y_hat_0_0 = (y_q_r_0 + means_0) * mask0
    y_hat_1_1 = (y_q_r_0 + means_1) * mask1
    params = torch.cat((y_hat_0_0, y_hat_1_1, means, scales, quant_step),
                       dim=-1)
    scales_0, means_0, scales_1, means_1 = torch.chunk(
        spatial_prior(params), 4, dim=-1)
    scales_r_1 = scales_0 * mask1 + scales_1 * mask0
    return scales_r_1, (y_hat_0_0, y_hat_1_1, means_0, means_1)


def decompress_stage_c(y_q_r_1, carry, quant_step, row0: int = 0):
    y_hat_0_0, y_hat_1_1, means_0, means_1 = carry
    mask0, mask1 = _masks_like(means_0, row0)
    y_hat_0_1 = (y_q_r_1 + means_0) * mask1
    y_hat_1_0 = (y_q_r_1 + means_1) * mask0
    y_hat = torch.cat((y_hat_0_0 + y_hat_0_1, y_hat_1_1 + y_hat_1_0), dim=-1)
    return y_hat * quant_step
