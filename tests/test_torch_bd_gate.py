"""PyTorch port, the bf16 BD-rate gate (vcm_ts_tpu_torch.bf16_bd_gate)
against the JAX package's engine and BD metrics.

The f32 operating point at one rate anchor: one 64x64 P-frame of the
overfit tool's synthetic clip at tiny widths (DMC 16/16/24, 2 anchors)
on the port's seeded damped init carried into the JAX model
(`flax_params_like`). The port's stream equals the JAX engine's byte for
byte, so the rate is equal; the recon PSNR against the source agrees
within 1e-4 dB (two stacks' f32 recons). The BD-rate and validity
arithmetic on fixed curves equals the JAX package's bd_metrics and the
JAX tool's gate expressions.
"""

from __future__ import annotations

import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_warp_twopass import (flax_params_like,  # noqa: F401
                                           one_torch_thread)
from tools.overfit_run import make_synthetic_batch as j_batch
from vcm_ts_tpu.codec.engine import VideoCodec as JVideoCodec
from vcm_ts_tpu.eval import bd_metrics as jbd
from vcm_ts_tpu.models.dmc import DMC as JDMC
from vcm_ts_tpu.models.dmc import make_dpb as j_make_dpb
from vcm_ts_tpu_torch import bf16_bd_gate as gate
from vcm_ts_tpu_torch.codec.engine import VideoCodec
from vcm_ts_tpu_torch.models.dmc import DMC, make_dpb
from vcm_ts_tpu_torch.utils.weights import init_params

CH = (16, 16, 24)
# a fine anchor (1.38 bpp here), so the stream bytes have teeth; the
# gate takes it through --anchors
ANCHOR = (0.1, 0.1)


def _jax_point(jd, params, ref, x):
    codec = JVideoCodec(jd, params)
    codec.update()
    out = codec.compress(jnp.asarray(x), j_make_dpb(jnp.asarray(ref), CH[1],
                                                     CH[2]),
                         *ANCHOR, is_first_p=True)
    rec = np.asarray(out["dpb"]["ref_frame"], np.float32)
    return out["bit_stream"], -10.0 * np.log10(np.mean((rec - x) ** 2)
                                               + 1e-12)


def test_f32_point_matches_the_jax_engine(tmp_path):
    port = init_params(DMC(anchor_num=2, channel_mv=CH[0], channel_N=CH[1],
                           channel_M=CH[2], device="cpu"), seed=0,
                       kernel_scale=0.5).eval()
    jd = JDMC(anchor_num=2, channel_mv=CH[0], channel_N=CH[1],
              channel_M=CH[2])
    x0 = jnp.zeros((1, 64, 64, 3))
    params = flax_params_like(
        lambda: jd.init(jax.random.PRNGKey(0), x0, j_make_dpb(x0, CH[1],
                                                              CH[2]),
                        1.0, 1.0, method="init_all"), port)
    seq = gate.make_synthetic_batch(1, 2, 64)[0]
    np.testing.assert_array_equal(seq, j_batch(1, 2, 64)[0])
    ref, x = seq[0:1], seq[1:2]
    # the port's checkpoint path: a .pth of the state_dict, read back
    torch.save(port.state_dict(), tmp_path / "dmc.pth")
    loaded = gate.load_dmc(str(tmp_path / "dmc.pth"), CH, 2, "cpu")
    # XLA compiles the JAX engine outside the interpreter lock
    with ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(_jax_point, jd, params, ref, x)
        pts = gate.sweep(loaded, torch.float32, ref, [x], [ANCHOR],
                         torch.device("cpu"))
        codec = VideoCodec(loaded, device="cpu")
        codec.update()
        stream = codec.compress(torch.from_numpy(x),
                                make_dpb(torch.from_numpy(ref), CH[1],
                                         CH[2]),
                                *ANCHOR, is_first_p=True)["bit_stream"]
        j_stream, j_psnr = jax_run.result()
    assert len(stream) > 100 and stream == j_stream
    assert pts.shape == (1, 2)
    assert pts[0, 0] == len(j_stream) * 8 / (64 * 64)
    assert abs(pts[0, 1] - j_psnr) <= 1e-4


def test_ckpt_routes():
    with pytest.raises(NotImplementedError, match="save_torch_state_dict"):
        gate.load_dmc("model.ckpt", CH, 2, "cpu")


CURVES = {
    "shifted": ([0.1, 0.2, 0.4, 0.8], [30.0, 32.0, 34.0, 36.0],
                [0.105, 0.21, 0.41, 0.83], [30.01, 31.98, 34.02, 35.97]),
    "flat": ([0.1, 0.2, 0.4, 0.8], [30.0, 30.1, 30.2, 30.3],
             [0.1, 0.2, 0.4, 0.8], [30.0, 30.1, 30.2, 30.3]),
    "disjoint": ([0.1, 0.2], [30.0, 31.0], [0.3, 0.4], [33.0, 34.0]),
}


@pytest.mark.parametrize("name", sorted(CURVES))
def test_bd_and_validity_equal_the_jax_arithmetic(name):
    ra, qa, rt, qt = (np.asarray(v) for v in CURVES[name])
    want = jbd.bd_rate(ra, qa, rt, qt)
    got = gate.bd_rate(ra, qa, rt, qt)
    np.testing.assert_equal(got, want)
    f32, test = np.stack([ra, qa], 1), np.stack([rt, qt], 1)
    args = types.SimpleNamespace(ckpt="c.pth", frames=2, size=256)
    rep = gate.report(args, f32, test, test, got, got)
    # the JAX tool's expressions (tools/bf16_bd_gate.py:106-125)
    span = min(f32[:, 1].max() - f32[:, 1].min(),
               test[:, 1].max() - test[:, 1].min())
    valid = bool(span >= 0.5)
    assert rep["psnr_span_db"] == round(float(span), 4)
    assert rep["bd_valid"] == valid
    assert rep["bf16_neutral"] == bool(valid and abs(want) < 1.0)
    assert rep["mixed_neutral"] == rep["bf16_neutral"]
    np.testing.assert_equal(rep["bd_rate_pct"], round(float(want), 4))
