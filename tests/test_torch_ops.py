"""PyTorch port, ops: the plain versions of kernels A/B/C, resize, math and
the layer zoo against the JAX package on the CPU (f32).

The JAX Pallas kernels run in interpret mode, as tests/test_subpel_pallas.py
runs them. Tolerances: the relayout (C) is a pure copy and must be exact;
the warp (A) rounds every op as the JAX gather-lerp does, atol 1e-6; the
fused 1x1 conv (B) and the conv stacks sum in another order than XLA,
atol 1e-5 (1e-5 / rtol 1e-4 for modules). The kernels themselves are
compared with these plain versions on the card
(tests/test_torch_kernels_cuda.py and chip_smoke.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_warp_twopass import (flax_params_like,  # noqa: F401
                                           one_torch_thread)
from tests.torch_port_util import load_flax, nchw, nhwc
from vcm_ts_tpu.ops import layers as jl
from vcm_ts_tpu.ops import math as jm
from vcm_ts_tpu.ops import resize as jr
from vcm_ts_tpu.ops.subpel_pallas import (_relayout_impl_fulllane,
                                          permute_out_channels as j_permute,
                                          pixel_shuffle_relayout as j_relayout,
                                          subpel_conv1x1 as j_conv1x1)
from vcm_ts_tpu.ops.warp import flow_warp as j_flow_warp
from vcm_ts_tpu.ops.warp import flow_warp_packed as j_flow_warp_packed
from vcm_ts_tpu_torch.ops import layers as tl
from vcm_ts_tpu_torch.ops import math as tm
from vcm_ts_tpu_torch.ops import resize as tr
from vcm_ts_tpu_torch.ops import subpel as ts
from vcm_ts_tpu_torch.ops import warp as tw
from vcm_ts_tpu_torch.utils.weights import init_params


def _flow(rng, n, h, w, scale):
    # large displacements: many samples fall outside and must clamp
    return rng.normal(0, scale, (n, h, w, 2)).astype(np.float32)


# ------------------------------------------------------------------ kernel A
@pytest.mark.parametrize("n,h,w,c,scale", [(1, 16, 24, 3, 4.0),
                                           (2, 12, 20, 64, 9.0),
                                           (1, 9, 13, 5, 30.0)])
def test_warp_plain_matches_jax_flow_warp(n, h, w, c, scale):
    rng = np.random.default_rng(c)
    im = rng.standard_normal((n, h, w, c)).astype(np.float32)
    flow = _flow(rng, n, h, w, scale)
    want = np.asarray(j_flow_warp(jnp.asarray(im), jnp.asarray(flow)))
    got = nhwc(tw.flow_warp(nchw(im), nchw(flow)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_warp_packed_plain_matches_jax_packed():
    """The 67-channel motion-compensation call: frame + feature, one flow."""
    rng = np.random.default_rng(7)
    frame = rng.random((1, 16, 24, 3)).astype(np.float32)
    feat = rng.standard_normal((1, 16, 24, 64)).astype(np.float32)
    flow = _flow(rng, 1, 16, 24, 6.0)
    want = j_flow_warp_packed((jnp.asarray(frame), jnp.asarray(feat)),
                              jnp.asarray(flow))
    got = tw.flow_warp_packed((nchw(frame), nchw(feat)), nchw(flow))
    assert len(got) == 2
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(wnt), rtol=0,
                                   atol=1e-6)
    # packed == separate, bit for bit
    single = tw.flow_warp(nchw(feat), nchw(flow))
    np.testing.assert_array_equal(nhwc(got[1]), nhwc(single))


def test_warp_plain_bf16_keeps_f32_coordinates():
    """bf16 data, f32 coordinates: pixel indices above 256 stay exact."""
    rng = np.random.default_rng(3)
    im = rng.standard_normal((1, 4, 600, 8)).astype(np.float32)
    flow = np.zeros((1, 4, 600, 2), np.float32)
    flow[..., 0] = 0.25
    want = np.asarray(j_flow_warp(jnp.asarray(im, jnp.bfloat16),
                                  jnp.asarray(flow)).astype(jnp.float32))
    got = tw.flow_warp(nchw(im).to(torch.bfloat16), nchw(flow))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(nhwc(got.float()), want)


# ------------------------------------------------------------------ kernel C
@pytest.mark.parametrize("n,h,w,c,r", [(2, 8, 16, 8, 2), (1, 5, 7, 3, 2),
                                       (1, 4, 4, 2, 3), (1, 6, 10, 64, 2),
                                       (1, 3, 5, 32, 2)])
def test_relayout_plain_matches_both_pallas_kernels(n, h, w, c, r):
    rng = np.random.default_rng(h * w + c)
    x = rng.standard_normal((n, h, w, r * r * c)).astype(np.float32)
    got = nhwc(ts.pixel_shuffle_relayout(nchw(x), r))
    want = np.asarray(j_relayout(jnp.asarray(x), r, interpret=True))
    full = np.asarray(_relayout_impl_fulllane(jnp.asarray(x), r, 8, True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, full)


def test_permute_out_channels_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 3, 5, 24)).astype(np.float32)  # HWIO
    want = np.asarray(j_permute(jnp.asarray(w), 2)).transpose(3, 2, 0, 1)
    got = ts.permute_out_channels(
        torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), 2).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ kernel B
@pytest.mark.parametrize("cin,c", [(16, 8), (64, 32), (64, 2), (96, 96)])
def test_subpel_conv1x1_plain_matches_pallas(cin, c):
    rng = np.random.default_rng(cin + c)
    r, h, w = 2, 6, 10
    x = rng.standard_normal((1, h, w, cin)).astype(np.float32)
    wk = rng.standard_normal((r * r, cin, c)).astype(np.float32) / cin ** 0.5
    bk = rng.standard_normal((r * r, c)).astype(np.float32)
    want = np.asarray(j_conv1x1(jnp.asarray(x), jnp.asarray(wk),
                                jnp.asarray(bk), r, interpret=True))
    got = nhwc(ts.subpel_conv1x1(nchw(x), torch.from_numpy(wk),
                                 torch.from_numpy(bk), r))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_pixel_shuffle_matches_jax():
    x = np.random.default_rng(2).standard_normal((1, 3, 5, 12)).astype(
        np.float32)
    np.testing.assert_array_equal(
        nhwc(tl.pixel_shuffle(nchw(x), 2)),
        np.asarray(jl.pixel_shuffle(jnp.asarray(x), 2)))


def test_wrappers_refuse_devices_without_a_version():
    x = torch.empty((1, 4, 2, 2), device="meta")
    with pytest.raises(ValueError):
        ts.pixel_shuffle_relayout(x)
    with pytest.raises(ValueError):
        tw.flow_warp(x, torch.empty((1, 2, 2, 2), device="meta"))


# ------------------------------------------------------------ resize / math
@pytest.mark.parametrize("name", ["bilinear_up2", "bilinear_down2",
                                  "avg_pool2", "max_pool2"])
def test_resize_matches_jax(name):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 12, 3)).astype(np.float32)
    want = np.asarray(getattr(jr, name)(jnp.asarray(x)))
    got = nhwc(getattr(tr, name)(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_math_matches_jax():
    rng = np.random.default_rng(6)
    # symbols within a few sigma: far tails are a difference of two CDF
    # values near 1, where the two libraries' erf/expm1 ulps dominate
    s = (0.3 + np.abs(rng.normal(0, 2, (4, 5, 6, 7)))).astype(np.float32)
    y = np.round(rng.normal(0, 1, s.shape) * s).astype(np.float32)
    s.flat[:20] = 0.0  # below both clips
    y.flat[:20] = 0.0
    p = rng.random(y.shape).astype(np.float32)
    for jf, tf, args in ((jm.laplace_bits, tm.laplace_bits, (y, s)),
                         (jm.gaussian_bits, tm.gaussian_bits, (y, s)),
                         (jm.probs_to_bits, tm.probs_to_bits, (p,)),
                         (jm.lower_bound, tm.lower_bound, (y, 0.5))):
        want = np.asarray(jf(*[jnp.asarray(a) for a in args]))
        got = tf(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                   for a in args]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=jf.__name__)
    halves = np.arange(-5.5, 6.0, 1.0, dtype=np.float32)  # half to even
    np.testing.assert_array_equal(
        tm.quant_round(torch.from_numpy(halves)).numpy(),
        np.asarray(jm.quant_round(jnp.asarray(halves))))


# ------------------------------------------------------------------- layers
def _hyper(which, y_ch, z_ch):
    return jl.hyper_enc_dec_models(y_ch, z_ch)[which]()


def _encdec(which, i, o, ch):
    return jl.enc_dec_models(i, o, ch)[which]()


# (jax module, port module, NHWC input shape)
LAYER_CASES = {
    "subpel_k1": (lambda: jl.SubpelConv(16, 2, 1),
                  lambda: tl.SubpelConv(12, 16, 2, 1), (1, 6, 8, 12)),
    "subpel_k3": (lambda: jl.SubpelConv(8, 2, 3),
                  lambda: tl.SubpelConv(12, 8, 2, 3), (1, 6, 8, 12)),
    "residual_block": (lambda: jl.ResidualBlock(16),
                       lambda: tl.ResidualBlock(16), (1, 8, 8, 16)),
    "residual_block_with_stride": (
        lambda: jl.ResidualBlockWithStride(16, 2),
        lambda: tl.ResidualBlockWithStride(3, 16, 2), (1, 8, 8, 3)),
    "residual_block_upsample": (
        lambda: jl.ResidualBlockUpsample(16, 2),
        lambda: tl.ResidualBlockUpsample(24, 16, 2), (1, 4, 6, 24)),
    "resblock_bottleneck": (
        lambda: jl.ResBlock(32, bottleneck=True, slope=0.1,
                            end_with_relu=True),
        lambda: tl.ResBlock(32, bottleneck=True, slope=0.1,
                            end_with_relu=True), (1, 8, 8, 32)),
    "resblock_relu": (lambda: jl.ResBlock(16, slope=0.0),
                      lambda: tl.ResBlock(16, slope=0.0), (1, 8, 8, 16)),
    "se_layer": (lambda: jl.SELayer(32), lambda: tl.SELayer(32),
                 (2, 8, 8, 32)),
    "conv_block_residual": (lambda: jl.ConvBlockResidual(32),
                            lambda: tl.ConvBlockResidual(16, 32),
                            (1, 8, 8, 16)),
    "unet": (lambda: jl.UNet(16), lambda: tl.UNet(20, 16), (1, 16, 16, 20)),
    "me_basic": (lambda: jl.MEBasic(), lambda: tl.MEBasic(8), (1, 16, 16, 8)),
    "enc": (partial(_encdec, 0, 2, 2, 16),
            lambda: tl.enc_dec_models(2, 2, 16)[0], (1, 32, 32, 2)),
    "dec": (partial(_encdec, 1, 2, 2, 16),
            lambda: tl.enc_dec_models(2, 2, 16)[1], (1, 2, 2, 16)),
    "hyper_enc": (partial(_hyper, 0, 24, 16),
                  lambda: tl.hyper_enc_dec_models(24, 16)[0], (1, 8, 8, 24)),
    "hyper_dec": (partial(_hyper, 1, 24, 16),
                  lambda: tl.hyper_enc_dec_models(24, 16)[1], (1, 2, 2, 16)),
}


@pytest.mark.parametrize("fast_shuffle", [False, True])
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layers_match_jax(case, fast_shuffle):
    """Each port module, loaded with the JAX params (damped control: the
    port's seeded init with every weight x 0.5 and biases 0.01, carried
    into the JAX tree by `flax_params_like`; an eager flax init took most
    of this file's time), equals the JAX module with fast-shuffle off and
    on (the same function)."""
    jmod_f, tmod_f, shape = LAYER_CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal(shape).astype(np.float32)
    jmod = jmod_f()
    params = flax_params_like(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)),
        init_params(tmod_f(), seed=len(case), kernel_scale=0.5))
    jl.set_fast_shuffle(fast_shuffle)
    try:
        want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    finally:
        jl.set_fast_shuffle(False)
    tmod = load_flax(tmod_f(), params).to(memory_format=torch.channels_last)
    with torch.no_grad():
        got = nhwc(tmod(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_subpel_conv_caches_kmajor_weights_per_load():
    """Where no gradient is recorded (the codec's paths), the k-major form
    is derived once per load, not per call, and a reload refreshes it;
    while a gradient to the weights is recorded it is derived every call,
    differentiably (the training slice)."""
    m = tl.SubpelConv(8, 4, 2, 1)
    with torch.no_grad():
        w1 = m.kmajor_weights()
        assert m.kmajor_weights()[0] is w1[0]
        m._modules["0"].weight.mul_(2.0)
        assert m.kmajor_weights()[0] is not w1[0]
    wg = m.kmajor_weights()[0]
    assert wg.requires_grad and m.kmajor_weights()[0] is not wg
