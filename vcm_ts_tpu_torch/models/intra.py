"""IntraNoAR — the I-frame (image) compression model.

Counterpart of vcm_ts_tpu/models/intra.py: hyperprior autoencoder (N=192)
with dual-spatial-prior checkerboard coding and a UNet refinement head.
Frames, latents and symbol planes cross the methods NHWC; the conv stacks
run NCHW with channels_last memory. Decompression is staged into three
methods around the host rANS reads (codec/engine.py). Inference only.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..entropy.bit_estimator import BitEstimator
from ..ops.layers import (UNet, conv, enc_dec_models, hyper_enc_dec_models,
                          to_nchw, to_nhwc)
from ..ops.math import gaussian_bits, lower_bound, probs_to_bits
from ..utils.device import resolve_device
from . import common
from .dmc import _prior_stack, _q


class IntraNoAR(nn.Module):
    """`spatial`: as DMC's (models/dmc.py)."""

    spatial = None

    def __init__(self, N: int = 192, anchor_num: int = 4, device="cuda"):
        super().__init__()
        self.N, self.anchor_num = N, anchor_num
        self.enc, self.dec = enc_dec_models(3, 16, N)
        self.refine = nn.Sequential(UNet(16, 16), conv(16, 3, 3))
        self.hyper_enc, self.hyper_dec = hyper_enc_dec_models(N, N)
        self.y_prior_fusion = _prior_stack(N * 2, N * 3, N * 3, N * 3)
        self.y_spatial_prior = _prior_stack(N * 4, N * 3, N * 3, N * 2)
        self.q_basic = nn.Parameter(torch.ones(1, N, 1, 1))
        self.q_scale = nn.Parameter(torch.ones(anchor_num, 1, 1, 1))
        self.bit_estimator_z = BitEstimator(N)
        self.to(device=resolve_device(device),
                memory_format=torch.channels_last)

    # ------------------------------------------------------------------ util
    def get_curr_q(self, q_scale):
        """(1, N, 1, 1) NCHW quantization step."""
        return lower_bound(self.q_basic, 0.5) * _q(q_scale, self.q_basic)

    def _fusion_params(self, z_hat):
        """NHWC z_hat -> NHWC (q_step, scales, means)."""
        p = self.y_prior_fusion(self.hyper_dec(to_nchw(z_hat)))
        return tuple(to_nhwc(t) for t in torch.chunk(p, 3, dim=1))

    def _spatial_prior(self, p):
        return to_nhwc(self.y_spatial_prior(to_nchw(p)))

    def _row0(self, t) -> int:
        return common.plane_row0(self.spatial, t)

    def _plane_sum(self, t, nchw: bool = False):
        return common.plane_sum(self.spatial, t, nchw)

    def _z_bits(self, z):
        zc = to_nchw(z)
        return probs_to_bits(self.bit_estimator_z(zc + 0.5)
                             - self.bit_estimator_z(zc - 0.5))

    # --------------------------------------------------------------- forward
    def forward(self, x, q_scale):
        """Forward with analytic bit costs (eval mode); x is NHWC."""
        curr_q = self.get_curr_q(q_scale)
        y = to_nhwc(self.enc(to_nchw(x)) / curr_q)
        z = to_nhwc(self.hyper_enc(to_nchw(y)))
        z_hat = common.quant(z)

        q_step, scales, means = self._fusion_params(z_hat)
        res = common.forward_dual_prior(y, means, scales, q_step,
                                        self._spatial_prior,
                                        row0=self._row0(y))
        y_hat = res.y_hat * to_nhwc(curr_q)
        x_hat = to_nhwc(self.refine(self.dec(to_nchw(y_hat))))

        bits_y = gaussian_bits(res.y_q, res.scales_hat)
        bits_z = self._z_bits(z_hat)
        _, h, w, _ = x.shape
        if self.spatial is not None:
            h, w = self.spatial.frame_hw()
        pixel_num = h * w
        bpp_y = self._plane_sum(bits_y) / pixel_num
        bpp_z = self._plane_sum(bits_z, nchw=True) / pixel_num
        mse = self._plane_sum((x - x_hat) ** 2) / pixel_num
        return {
            "x_hat": x_hat,
            "mse": mse,
            "bit": torch.sum(bpp_y + bpp_z) * pixel_num,
            "bpp": bpp_y + bpp_z,
            "bpp_y": bpp_y,
            "bpp_z": bpp_z,
        }

    # -------------------------------------------------------------- compress
    def encode_front(self, x, q_scale):
        """Encoder-only analysis transform: y latent + rounded hyper
        symbols (NHWC)."""
        y = self.enc(to_nchw(x)) / self.get_curr_q(q_scale)
        z = self.hyper_enc(y)
        return to_nhwc(y), to_nhwc(torch.round(z))

    # ------------------------------------------------------------ decompress
    def decompress_stage1(self, z_hat, q_scale):
        """hyper decode + prior fusion -> step-0 coding scales."""
        q_step, scales, means = self._fusion_params(z_hat)
        scales_r_0, q_step = common.decompress_stage_a(scales, q_step,
                                                       self._row0(scales))
        return scales_r_0, (means, scales, q_step)

    def decompress_stage2(self, y_q_r_0, carry):
        means, scales, q_step = carry
        scales_r_1, carry2 = common.decompress_stage_b(
            y_q_r_0, means, scales, q_step, self._spatial_prior,
            self._row0(means))
        return scales_r_1, carry2 + (q_step,)

    def decompress_stage3(self, y_q_r_1, carry, q_scale):
        y_hat_0_0, y_hat_1_1, means_0, means_1, q_step = carry
        y_hat = common.decompress_stage_c(
            y_q_r_1, (y_hat_0_0, y_hat_1_1, means_0, means_1), q_step,
            self._row0(means_0))
        y_hat = y_hat * to_nhwc(self.get_curr_q(q_scale))
        x_hat = self.refine(self.dec(to_nchw(y_hat)))
        return torch.clamp(to_nhwc(x_hat), 0.0, 1.0)
