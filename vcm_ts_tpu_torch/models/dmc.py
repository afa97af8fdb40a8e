"""DMC — the conditional-coding P-frame model.

Counterpart of vcm_ts_tpu/models/dmc.py: SpyNet flow -> MV codec with
hyperprior and temporal prior -> motion compensation over a 3-scale feature
pyramid -> contextual encoder/decoder with the dual-prior checkerboard
entropy model -> UNet reconstruction.

Tensors cross the methods NHWC, as in the JAX package (frames, DPB, latents,
symbol and scale planes, contexts); inside, the conv stacks run NCHW with
channels_last memory, so each crossing is a view. The DPB is a dict of dense
tensors; `is_first_p` selects the I-frame feature adaptor.

Decompression is split into stages around the host rANS reads; the stream
order (mv_z, mv_y0, mv_y1, z, y0, y1) is the JAX package's. The encoder
(codec/engine.py) runs the same decompress stages as the decoder for every
prior the stream depends on.

`forward(..., training=True, noise=...)` is the training forward of
vcm_ts_tpu/models/dmc.py:216-307: straight-through rounding, and bits of
the latents plus U(-0.5, 0.5) noise. Every op on it is differentiable;
the warps and subpel convs take their hand-written backward kernels.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..entropy.bit_estimator import BitEstimator
from ..ops.layers import (conv, enc_dec_models, hyper_enc_dec_models,
                          SubpelConv, to_nchw, to_nhwc)
from ..ops.math import (add_uniform_noise, laplace_bits, lower_bound,
                        probs_to_bits)
from ..ops.resize import bilinear_down2
from ..ops.warp import flow_warp, flow_warp_packed
from ..ops.warp_twopass import flow_warp_twopass
from ..utils.device import resolve_device, to_device
from . import common
from .video_net import (ContextualDecoder, ContextualEncoder, FeatureExtractor,
                        MESpynet, MultiScaleContextFusion, ReconGeneration)

CL = torch.channels_last


def make_dpb(x, channel_N: int = 64, channel_M: int = 96):
    """Fresh decoded-picture buffer (NHWC) seeded with a reference frame."""
    n, h, w, _ = x.shape

    def z(hh, ww, c):
        return torch.zeros((n, hh, ww, c), dtype=x.dtype, device=x.device)

    return {
        "ref_frame": x,
        "ref_feature": z(h, w, channel_N),
        "ref_y": z(h // 16, w // 16, channel_M),
        "ref_mv_y": z(h // 16, w // 16, channel_N),
    }


def _prior_stack(cin, c1, c2, c3, slope=0.2):
    return nn.Sequential(conv(cin, c1), nn.LeakyReLU(slope),
                         conv(c1, c2), nn.LeakyReLU(slope), conv(c2, c3))


def _q(q, like: torch.Tensor) -> torch.Tensor:
    """A q-scale as a tensor in `like`'s dtype, on its device, made without
    a host wait: a float, or an (N, 1, 1, 1) array or tensor with one row
    per stream of a batch."""
    if isinstance(q, (int, float)):
        return torch.full((), q, dtype=like.dtype, device=like.device)
    return to_device(torch.as_tensor(q, dtype=like.dtype), like.device)


class DMC(nn.Module):
    """`fast_warp` routes every warp of SpyNet and of motion compensation
    through the two-pass warp (kernel D, ops/warp_twopass.py) in place of
    the exact warp: opt-in, as in the JAX package.

    `spatial`: the SpatialAxis of a model split by rows
    (parallel/spatial.shard_spatial_model), else None. Split, every method
    takes and returns this rank's rows of each plane that tiles the axis
    (whole planes otherwise), inside SpatialAxis.frame; the bits, bpp and
    mse cover the whole frame. Inference only."""

    spatial = None

    def __init__(self, anchor_num: int = 4, channel_mv: int = 64,
                 channel_N: int = 64, channel_M: int = 96,
                 fast_warp: bool = False, device="cuda"):
        super().__init__()
        cm, cn, cM = channel_mv, channel_N, channel_M
        self.anchor_num, self.channel_mv = anchor_num, cm
        self.channel_N, self.channel_M = cn, cM
        self.fast_warp = fast_warp

        self.optic_flow = MESpynet(fast_warp=fast_warp)
        self.mv_encoder, self.mv_decoder = enc_dec_models(2, 2, cm)
        (self.mv_hyper_prior_encoder,
         self.mv_hyper_prior_decoder) = hyper_enc_dec_models(cm, cn)
        self.mv_y_prior_fusion = _prior_stack(cm * 2 + cn, cm * 3, cm * 3,
                                              cm * 3)
        self.mv_y_spatial_prior = _prior_stack(cm * 4, cm * 3, cm * 3, cm * 2)

        self.feature_adaptor_I = conv(3, cn, 3)
        self.feature_adaptor_P = conv(cn, cn, 1)
        self.feature_extractor = FeatureExtractor(cn)
        self.context_fusion_net = MultiScaleContextFusion(cn)

        self.contextual_encoder = ContextualEncoder(cn, cM)
        self.contextual_hyper_prior_encoder = nn.Sequential(
            conv(cM, cn), nn.LeakyReLU(0.01),
            conv(cn, cn, 3, 2), nn.LeakyReLU(0.01),
            conv(cn, cn, 3, 2))
        cM15 = cM * 3 // 2
        self.contextual_hyper_prior_decoder = nn.Sequential(
            conv(cn, cM), nn.LeakyReLU(0.01),
            SubpelConv(cM, cM, 2, kernel=1), nn.LeakyReLU(0.01),
            conv(cM, cM15), nn.LeakyReLU(0.01),
            SubpelConv(cM15, cM15, 2, kernel=1), nn.LeakyReLU(0.01),
            conv(cM15, cM * 2))
        self.temporal_prior_encoder = nn.Sequential(
            conv(cn, cM15, 3, 2), nn.LeakyReLU(0.1),
            conv(cM15, cM * 2, 3, 2))
        self.y_prior_fusion = _prior_stack(cM * 5, cM * 4, cM * 3, cM * 3)
        self.y_spatial_prior = _prior_stack(cM * 4, cM * 3, cM * 3, cM * 2)

        self.contextual_decoder = ContextualDecoder(cn, cM)
        self.recon_generation_net = ReconGeneration(cn)

        self.mv_y_q_basic = nn.Parameter(torch.ones(1, cm, 1, 1))
        self.mv_y_q_scale = nn.Parameter(torch.ones(anchor_num, 1, 1, 1))
        self.y_q_basic = nn.Parameter(torch.ones(1, cM, 1, 1))
        self.y_q_scale = nn.Parameter(torch.ones(anchor_num, 1, 1, 1))

        self.bit_estimator_z = BitEstimator(cn)
        self.bit_estimator_z_mv = BitEstimator(cn)
        self.to(device=resolve_device(device), memory_format=CL)

    # ------------------------------------------------------------------ utils
    def get_curr_mv_y_q(self, q_scale):
        """(1, C, 1, 1) NCHW quantization step of the mv latent."""
        b = self.mv_y_q_basic
        return lower_bound(b, 0.5) * _q(q_scale, b)

    def get_curr_y_q(self, q_scale):
        b = self.y_q_basic
        return lower_bound(b, 0.5) * _q(q_scale, b)

    def _warp(self, im, flow, scale: int):
        sp = self.spatial
        if self.fast_warp:
            # the displacement bound shrinks with the pyramid scale
            d = max(6, 24 >> scale)
            if sp is None:
                return flow_warp_twopass(im, flow, d)
            return sp.warp_twopass(im, flow, d)
        return flow_warp(im, flow) if sp is None else sp.warp([im], flow)[0]

    def _down2(self, x):
        sp = self.spatial
        return (bilinear_down2(x) if sp is None
                else sp.resize(bilinear_down2, x))

    def _row0(self, t) -> int:
        return common.plane_row0(self.spatial, t)

    def _plane_sum(self, t, nchw: bool = False):
        return common.plane_sum(self.spatial, t, nchw)

    def _spatial(self, net):
        return lambda p: to_nhwc(net(to_nchw(p)))

    def multi_scale_feature_extractor(self, dpb, is_first_p: bool):
        if is_first_p:
            feature = self.feature_adaptor_I(to_nchw(dpb["ref_frame"]))
        else:
            feature = self.feature_adaptor_P(to_nchw(dpb["ref_feature"]))
        return self.feature_extractor(feature)

    def motion_compensation(self, dpb, mv, is_first_p: bool):
        """Multi-scale warped contexts (NCHW). With the exact warp, the
        reference frame and the full-res feature share one flow, so they go
        through one packed warp."""
        mv = mv.contiguous(memory_format=CL)
        mv2 = (self._down2(mv) / 2).contiguous(memory_format=CL)
        mv3 = (self._down2(mv2) / 2).contiguous(memory_format=CL)
        f1, f2, f3 = (f.contiguous(memory_format=CL) for f in
                      self.multi_scale_feature_extractor(dpb, is_first_p))
        ref = to_nchw(dpb["ref_frame"])
        if self.fast_warp:
            warpframe = self._warp(ref, mv, 0)
            context1 = self._warp(f1, mv, 0)
        elif self.spatial is None:
            warpframe, context1 = flow_warp_packed((ref, f1), mv)
        else:
            warpframe, context1 = self.spatial.warp((ref, f1), mv)
        context2 = self._warp(f2, mv2, 1)
        context3 = self._warp(f3, mv3, 2)
        context1, context2, context3 = self.context_fusion_net(
            context1, context2, context3)
        return context1, context2, context3, warpframe

    def _mv_prior(self, mv_z_hat, ref_mv_y):
        """NHWC in, NHWC (q_step, scales, means) out."""
        p = self.mv_hyper_prior_decoder(to_nchw(mv_z_hat))
        p = self.mv_y_prior_fusion(torch.cat((p, to_nchw(ref_mv_y)), dim=1))
        return tuple(to_nhwc(t) for t in torch.chunk(p, 3, dim=1))

    def _y_prior(self, z_hat, context3, ref_y):
        """z_hat, ref_y NHWC; context3 NCHW. NHWC out."""
        hierarchical = self.contextual_hyper_prior_decoder(to_nchw(z_hat))
        temporal = self.temporal_prior_encoder(context3)
        p = self.y_prior_fusion(
            torch.cat((temporal, hierarchical, to_nchw(ref_y)), dim=1))
        return tuple(to_nhwc(t) for t in torch.chunk(p, 3, dim=1))

    def _z_bits(self, z, est):
        zc = to_nchw(z)
        return probs_to_bits(est(zc + 0.5) - est(zc - 0.5))

    def noise_shapes(self, n: int, h: int, w: int):
        """Shapes (NHWC) of the four noise tensors forward takes for an
        (n, h, w) frame: y_res, mv_y_res, z, mv_z."""
        return ((n, h // 16, w // 16, self.channel_M),
                (n, h // 16, w // 16, self.channel_mv),
                (n, h // 64, w // 64, self.channel_N),
                (n, h // 64, w // 64, self.channel_N))

    # ---------------------------------------------------------------- forward
    def forward(self, x, dpb, mv_y_q_scale, y_q_scale,
                is_first_p: bool = False, training: bool = False,
                noise=None):
        """Per-frame forward with analytic bit costs; x and the DPB are
        NHWC. `training` rounds with a straight-through gradient; `noise`
        (training only) holds U(-0.5, 0.5) tensors for y_res, mv_y_res, z
        and mv_z (noise_shapes; the order of the JAX package's key split),
        and the bits are then those of the noisy values, else of the
        rounded ones."""
        if training and self.spatial is not None:
            raise NotImplementedError("a model split by rows runs inference "
                                      "only")
        curr_mv_y_q = self.get_curr_mv_y_q(mv_y_q_scale)
        curr_y_q = self.get_curr_y_q(y_q_scale)
        xc = to_nchw(x)

        est_mv = self.optic_flow(xc, to_nchw(dpb["ref_frame"]))
        mv_y = to_nhwc(self.mv_encoder(est_mv) / curr_mv_y_q)
        mv_z = to_nhwc(self.mv_hyper_prior_encoder(to_nchw(mv_y)))
        mv_z_hat = common.quant(mv_z, training)
        mv_q_step, mv_scales, mv_means = self._mv_prior(
            mv_z_hat, dpb["ref_mv_y"])
        mv_res = common.forward_dual_prior(
            mv_y, mv_means, mv_scales, mv_q_step,
            self._spatial(self.mv_y_spatial_prior), training=training,
            row0=self._row0(mv_y))
        mv_y_hat = mv_res.y_hat * to_nhwc(curr_mv_y_q)

        mv_hat = self.mv_decoder(to_nchw(mv_y_hat))
        context1, context2, context3, warp_frame = self.motion_compensation(
            dpb, mv_hat, is_first_p)

        y = to_nhwc(self.contextual_encoder(xc, context1, context2, context3)
                    / curr_y_q)
        z = to_nhwc(self.contextual_hyper_prior_encoder(to_nchw(y)))
        z_hat = common.quant(z, training)
        q_step, scales, means = self._y_prior(z_hat, context3, dpb["ref_y"])
        y_res = common.forward_dual_prior(
            y, means, scales, q_step, self._spatial(self.y_spatial_prior),
            training=training, row0=self._row0(y))
        y_hat = y_res.y_hat * to_nhwc(curr_y_q)

        recon_feat = self.contextual_decoder(to_nchw(y_hat), context2,
                                             context3)
        feature, recon_image = self.recon_generation_net(recon_feat, context1)
        recon_image = to_nhwc(recon_image)

        _, h, w, _ = x.shape
        if self.spatial is not None:
            h, w = self.spatial.frame_hw()
        pixel_num = h * w
        mse = self._plane_sum((x - recon_image) ** 2) / pixel_num
        me_mse = self._plane_sum((x - to_nhwc(warp_frame)) ** 2) / pixel_num

        if training and noise is not None:
            n_y, n_mv_y, n_z, n_mv_z = noise
            y_for_bit = add_uniform_noise(y_res.y_res, n_y)
            mv_y_for_bit = add_uniform_noise(mv_res.y_res, n_mv_y)
            z_for_bit = add_uniform_noise(z, n_z)
            mv_z_for_bit = add_uniform_noise(mv_z, n_mv_z)
        else:
            y_for_bit, mv_y_for_bit = y_res.y_q, mv_res.y_q
            z_for_bit, mv_z_for_bit = z_hat, mv_z_hat

        bits_y = laplace_bits(y_for_bit, y_res.scales_hat)
        bits_mv_y = laplace_bits(mv_y_for_bit, mv_res.scales_hat)
        bits_z = self._z_bits(z_for_bit, self.bit_estimator_z)
        bits_mv_z = self._z_bits(mv_z_for_bit, self.bit_estimator_z_mv)

        bpp_y = self._plane_sum(bits_y) / pixel_num
        bpp_z = self._plane_sum(bits_z, nchw=True) / pixel_num
        bpp_mv_y = self._plane_sum(bits_mv_y) / pixel_num
        bpp_mv_z = self._plane_sum(bits_mv_z, nchw=True) / pixel_num
        bpp = bpp_y + bpp_z + bpp_mv_y + bpp_mv_z

        return {
            "bpp_mv_y": bpp_mv_y,
            "bpp_mv_z": bpp_mv_z,
            "bpp_y": bpp_y,
            "bpp_z": bpp_z,
            "bpp": bpp,
            "me_mse": me_mse,
            "mse": mse,
            "dpb": {
                "ref_frame": recon_image,
                "ref_feature": to_nhwc(feature),
                "ref_y": y_hat,
                "ref_mv_y": mv_y_hat,
            },
            "bit": torch.sum(bpp) * pixel_num,
            "bit_y": torch.sum(bpp_y) * pixel_num,
            "bit_z": torch.sum(bpp_z) * pixel_num,
            "bit_mv_y": torch.sum(bpp_mv_y) * pixel_num,
            "bit_mv_z": torch.sum(bpp_mv_z) * pixel_num,
        }

    forward_one_frame = forward

    # -------------------------------------------------------------- compress
    def encode_front(self, x, dpb, mv_y_q_scale):
        """Encoder-only MV analysis: mv latent + rounded hyper symbols."""
        curr_mv_y_q = self.get_curr_mv_y_q(mv_y_q_scale)
        est_mv = self.optic_flow(to_nchw(x), to_nchw(dpb["ref_frame"]))
        mv_y = self.mv_encoder(est_mv) / curr_mv_y_q
        mv_z = self.mv_hyper_prior_encoder(mv_y)
        return to_nhwc(mv_y), to_nhwc(torch.round(mv_z))

    def encode_latent(self, x, contexts, y_q_scale):
        """Encoder-only contextual analysis against the DECODER's contexts
        (from decompress_stage3a): y latent + rounded hyper symbols."""
        context1, context2, context3, _ = (to_nchw(c) for c in contexts)
        y = self.contextual_encoder(to_nchw(x), context1, context2, context3)
        y = y / self.get_curr_y_q(y_q_scale)
        z = self.contextual_hyper_prior_encoder(y)
        return to_nhwc(y), to_nhwc(torch.round(z))

    # ------------------------------------------------------------ decompress
    def decompress_stage1(self, mv_z_hat, dpb):
        """mv hyper decode -> step-0 mv coding scales."""
        mv_q_step, mv_scales, mv_means = self._mv_prior(
            mv_z_hat, dpb["ref_mv_y"])
        scales_r_0, mv_q_step = common.decompress_stage_a(
            mv_scales, mv_q_step, self._row0(mv_scales))
        return scales_r_0, (mv_means, mv_scales, mv_q_step)

    def decompress_stage2(self, mv_y_q_r_0, carry):
        """decoded mv step-0 symbols -> step-1 mv coding scales."""
        mv_means, mv_scales, mv_q_step = carry
        scales_r_1, carry2 = common.decompress_stage_b(
            mv_y_q_r_0, mv_means, mv_scales, mv_q_step,
            self._spatial(self.mv_y_spatial_prior), self._row0(mv_means))
        return scales_r_1, carry2 + (mv_q_step,)

    def decompress_stage3a(self, mv_y_q_r_1, carry, dpb, mv_y_q_scale,
                           is_first_p: bool = False):
        """Finish the mv reconstruction and motion-compensate; the encoder
        reuses it for the contexts its y latent is computed against."""
        y_hat_0_0, y_hat_1_1, means_0, means_1, mv_q_step = carry
        mv_y_hat = common.decompress_stage_c(
            mv_y_q_r_1, (y_hat_0_0, y_hat_1_1, means_0, means_1), mv_q_step,
            self._row0(means_0))
        mv_y_hat = mv_y_hat * to_nhwc(self.get_curr_mv_y_q(mv_y_q_scale))
        mv_hat = self.mv_decoder(to_nchw(mv_y_hat))
        context1, context2, context3, _ = self.motion_compensation(
            dpb, mv_hat, is_first_p)
        return (to_nhwc(context1), to_nhwc(context2), to_nhwc(context3),
                mv_y_hat)

    def decompress_stage3b(self, z_hat, context3, dpb):
        """z (static channel indexes) -> step-0 y coding scales."""
        q_step, scales, means = self._y_prior(z_hat, to_nchw(context3),
                                              dpb["ref_y"])
        scales_r_0, q_step = common.decompress_stage_a(scales, q_step,
                                                       self._row0(scales))
        return scales_r_0, (means, scales, q_step)

    def decompress_stage5(self, y_q_r_0, carry):
        """decoded y step-0 symbols -> step-1 y coding scales."""
        means, scales, q_step = carry
        scales_r_1, carry2 = common.decompress_stage_b(
            y_q_r_0, means, scales, q_step,
            self._spatial(self.y_spatial_prior), self._row0(means))
        return scales_r_1, carry2 + (q_step,)

    def decompress_stage6(self, y_q_r_1, carry, contexts, y_q_scale):
        """Reassemble y, reconstruct the frame, emit the new DPB (NHWC)."""
        y_hat_0_0, y_hat_1_1, means_0, means_1, q_step = carry
        context1, context2, context3, mv_y_hat = contexts
        y_hat = common.decompress_stage_c(
            y_q_r_1, (y_hat_0_0, y_hat_1_1, means_0, means_1), q_step,
            self._row0(means_0))
        y_hat = y_hat * to_nhwc(self.get_curr_y_q(y_q_scale))
        recon_feat = self.contextual_decoder(
            to_nchw(y_hat), to_nchw(context2), to_nchw(context3))
        feature, recon_image = self.recon_generation_net(
            recon_feat, to_nchw(context1))
        return {
            "dpb": {
                "ref_frame": torch.clamp(to_nhwc(recon_image), 0.0, 1.0),
                "ref_feature": to_nhwc(feature),
                "ref_y": y_hat,
                "ref_mv_y": mv_y_hat,
            },
        }
