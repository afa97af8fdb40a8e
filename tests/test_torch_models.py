"""PyTorch port, models: IntraNoAR.forward and a 4-frame chain of
DMC.forward_one_frame against the JAX modules on the CPU, full widths
(IntraNoAR N=192; DMC 64/64/96) at 64x64, on the damped control init
(every kernel x 0.5) carried across with the port's weights.py.

Tolerances: recon and every DPB tensor atol 1e-4 (f32 conv stacks summed
in another order than XLA, threaded through the chain); the bpp and mse
terms rtol 1e-4, except the intra Gaussian bpp_y (see its test).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import damp, load_flax, moving_frames, np_tree
from vcm_ts_tpu.models import common as j_common
from vcm_ts_tpu.models.dmc import DMC as JDMC
from vcm_ts_tpu.models.dmc import make_dpb as j_make_dpb
from vcm_ts_tpu.models.intra import IntraNoAR as JIntraNoAR
from vcm_ts_tpu_torch.models import common as tc
from vcm_ts_tpu_torch.models.dmc import DMC, make_dpb
from vcm_ts_tpu_torch.models.intra import IntraNoAR

SCALARS = ("bpp", "bpp_y", "bpp_z", "mse")
P_SCALARS = SCALARS + ("bpp_mv_y", "bpp_mv_z", "me_mse")


@pytest.fixture(scope="module")
def intra():
    jmodel = JIntraNoAR()
    params = damp(jmodel.init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 64, 3)), 1.0))
    return jmodel, params, load_flax(IntraNoAR(device="cpu"), params)


@pytest.fixture(scope="module")
def dmc():
    jmodel = JDMC(anchor_num=4)
    x0 = jnp.zeros((1, 64, 64, 3))
    params = damp(jmodel.init(jax.random.PRNGKey(1), x0, j_make_dpb(x0),
                              1.0, 1.0, method="init_all"))
    return jmodel, params, load_flax(DMC(device="cpu"), params)


def _check_scalars_rtol(got, want, keys, rtol, where=""):
    for k in keys:
        np.testing.assert_allclose(np_tree(got[k]), np.asarray(want[k]),
                                   rtol=rtol, atol=0, err_msg=f"{where}: {k}")


def _check_scalars(got, want, keys, where):
    _check_scalars_rtol(got, want, keys, 1e-4, where)


def test_intra_forward_matches_jax(intra):
    jmodel, params, port = intra
    x = moving_frames(0, 1)[0]
    want = jmodel.apply(params, jnp.asarray(x), 0.5)
    with torch.no_grad():
        got = port(torch.from_numpy(x), 0.5)
    np.testing.assert_allclose(np_tree(got["x_hat"]),
                               np.asarray(want["x_hat"]), rtol=0, atol=1e-4)
    _check_scalars(got, want, ("bpp_z", "mse"), "intra")
    # bpp_y: the symbols and scales agree (below), but a symbol of 1 at the
    # 0.11 sigma clip costs -log2(cdf(13.6) - cdf(4.5) + 1e-5), a difference
    # of two f32 values near 1: XLA's f32 erf is 2 ulp off there and gives
    # 16.2736 bits where torch's erf gives 16.2601 (measured on identical
    # inputs). Those tail symbols move bpp_y by ~6e-4 relative here.
    _check_scalars_rtol(got, want, ("bpp_y", "bpp"), 1e-3)

    def j_planes(m, xx):  # NHWC symbols and coding scales of the y latent
        y, z_hat = m.encode_front(xx, 0.5)
        q_step, scales, means = m._fusion_params(z_hat)
        res = j_common.forward_dual_prior(y, means, scales, q_step,
                                          m.y_spatial_prior)
        return res.y_q, res.scales_hat

    jq, js = jmodel.apply(params, jnp.asarray(x), method=j_planes)
    with torch.no_grad():
        y, z_hat = port.encode_front(torch.from_numpy(x), 0.5)
        q_step, scales, means = port._fusion_params(z_hat)
        res = tc.forward_dual_prior(y, means, scales, q_step,
                                    port._spatial_prior)
        tq, tsc = res.y_q, res.scales_hat
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(js), rtol=0,
                               atol=1e-5)


def test_dmc_forward_chain_matches_jax(dmc):
    """Four chained P-frames, each stack threading its own DPB;
    is_first_p on the first frame only."""
    jmodel, params, port = dmc
    frames = moving_frames(1, 5)
    fwd = jax.jit(partial(jmodel.apply, params),
                  static_argnames=("is_first_p",))
    jdpb = j_make_dpb(jnp.asarray(frames[0]))
    tdpb = make_dpb(torch.from_numpy(frames[0]))
    for t, x in enumerate(frames[1:]):
        first = t == 0
        want = fwd(jnp.asarray(x), jdpb, 0.7, 0.8, is_first_p=first)
        with torch.no_grad():
            got = port.forward_one_frame(torch.from_numpy(x), tdpb, 0.7, 0.8,
                                         is_first_p=first)
        for k in ("ref_frame", "ref_feature", "ref_y", "ref_mv_y"):
            np.testing.assert_allclose(
                np_tree(got["dpb"][k]), np.asarray(want["dpb"][k]), rtol=0,
                atol=1e-4, err_msg=f"frame {t}: dpb {k}")
        _check_scalars(got, want, P_SCALARS, f"frame {t}")
        jdpb, tdpb = want["dpb"], got["dpb"]


def test_encode_symbols_match_forward_dual_prior():
    """The encoder-side symbols against the decoder's stage buffers equal
    forward_dual_prior's write-path symbols (the port's copy of the JAX
    package's invariant)."""
    rng = np.random.default_rng(7)
    n, h, w, c = 1, 8, 12, 16
    y = torch.from_numpy(rng.normal(0, 3, (n, h, w, c)).astype(np.float32))
    means = torch.from_numpy(rng.normal(0, 1, (n, h, w, c)).astype(np.float32))
    scales = torch.from_numpy((rng.random((n, h, w, c)) + 0.1).astype(
        np.float32))
    q_raw = torch.from_numpy((rng.random((n, h, w, c)) + 0.2).astype(
        np.float32))

    def spatial_prior(p):
        return p[..., c:3 * c] * 0.5

    fwd = tc.forward_dual_prior(y, means, scales, q_raw, spatial_prior)
    q_step = torch.clamp_min(q_raw, 0.5)
    mask0, mask1 = tc.checkerboard_masks(h, w)
    y_q_0, y_q_1 = torch.chunk(fwd.y_q, 2, dim=-1)
    w0 = tc.encode_symbols_step0(y, means, q_step)
    torch.testing.assert_close(w0, y_q_0 * mask0 + y_q_1 * mask1, rtol=0,
                               atol=0)
    _, carry = tc.decompress_stage_b(w0, means, scales, q_step, spatial_prior)
    w1 = tc.encode_symbols_step1(y, carry[2], carry[3], q_step)
    torch.testing.assert_close(w1, y_q_0 * mask1 + y_q_1 * mask0, rtol=0,
                               atol=0)
