"""PyTorch port, precision: the bf16 and mixed policies (utils/precision.py)
and flax's dtype promotion against the JAX package on the CPU; the
engine's parameter-dtype rule; the port bench's JSON keys against
bench.py's.

Inputs are made with numpy from a seed; the models are the port's seeded
damped init carried into the JAX modules (`flax_params_like`, in
tests/test_torch_warp_twopass.py).

Tolerances. Output dtypes must be equal. Where a bf16 input meets f32
weights (or the reverse) both stacks compute in f32: rtol 1e-4 of the
output's scale, f32 noise plus the odd bf16 rounding of an activation that
XLA keeps in excess precision. Where weights and inputs are bf16: 2^-5 of
the output's scale (8 bf16 ulps): torch rounds to bf16 after every op and
XLA once per fused region, and across a module of up to 17 convs the two
drift by a few ulps. One DMC frame in bf16 or mixed: the recons agree to at
least 35 dB and bpp to 2 % (symbols near a rounding boundary can flip
between the stacks). The z CDF tables are built on the CPU in f32 from the
bf16 parameters and must be byte-equal.
"""

from __future__ import annotations

import copy
import json
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_ops import LAYER_CASES
from tests.test_torch_warp_twopass import flax_params_like
from tests.test_torch_warp_twopass import one_torch_thread  # noqa: F401
from tests.torch_port_util import moving_frames, nchw, nhwc, np_tree
from vcm_ts_tpu.entropy import bit_estimator as jbe
from vcm_ts_tpu.entropy.gaussian import GaussianCoder as JGaussianCoder
from vcm_ts_tpu.models.dmc import DMC as JDMC
from vcm_ts_tpu.models.dmc import make_dpb as j_make_dpb
from vcm_ts_tpu.models.intra import IntraNoAR as JIntraNoAR
from vcm_ts_tpu.ops import resize as jr
from vcm_ts_tpu.ops.warp import flow_warp_packed as j_flow_warp_packed
from vcm_ts_tpu.utils import precision as jp
from vcm_ts_tpu_torch import bench as tbench
from vcm_ts_tpu_torch.codec.engine import IntraCodec, VideoCodec, param_dtype
from vcm_ts_tpu_torch.entropy import bit_estimator as tbe
from vcm_ts_tpu_torch.entropy.gaussian import GaussianCoder
from vcm_ts_tpu_torch.models.dmc import make_dpb
from vcm_ts_tpu_torch.ops import resize as tr
from vcm_ts_tpu_torch.ops import warp as tw
from vcm_ts_tpu_torch.utils import precision as tp
from vcm_ts_tpu_torch.utils.weights import init_params, make_dmc, make_intra

BF16, F32 = torch.bfloat16, torch.float32
X0 = jnp.zeros((1, 64, 64, 3))


def _dmc_init(jmodel):
    return lambda: jmodel.init(jax.random.PRNGKey(0), X0, j_make_dpb(X0),
                               1.0, 1.0, method="init_all")


def _intra_init(jmodel):
    return lambda: jmodel.init(jax.random.PRNGKey(0), X0, 1.0)


@pytest.fixture(scope="module")
def dmc():
    """The port's seeded damped DMC (f32) and the JAX DMC holding its
    weights."""
    port = make_dmc("cpu").eval()
    jmodel = JDMC(anchor_num=4)
    return jmodel, flax_params_like(_dmc_init(jmodel), port), port


def _flax_names(tree, dtype):
    """Port-style names ("kernel" -> "weight") of the leaves of `dtype`."""
    names = set()
    for path, v in jax.tree_util.tree_leaves_with_path(tree["params"]):
        keys = [p.key for p in path]
        if keys[-1] == "kernel":
            keys[-1] = "weight"
        if v.dtype == dtype:
            names.add(".".join(keys))
    return names


def _port_names(module, dtype):
    return {n for n, p in module.named_parameters() if p.dtype == dtype}


# ----------------------------------------------------------------- policies
@pytest.mark.parametrize("which", ["dmc", "intra"])
def test_mixed_keeps_the_same_parameters_f32_by_name(which, dmc):
    if which == "dmc":
        params, port = dmc[1], copy.deepcopy(dmc[2])
    else:
        params = jax.eval_shape(_intra_init(JIntraNoAR()))
        port = make_intra("cpu")
    jmixed = jax.eval_shape(jp.cast_params_mixed, params)
    tmixed = tp.cast_params_mixed(port)
    for dt_j, dt_t in ((jnp.float32, F32), (jnp.bfloat16, BF16)):
        assert _flax_names(jmixed, dt_j) == _port_names(tmixed, dt_t)
    kept = _port_names(tmixed, F32)
    assert which == "intra" or {"y_q_basic", "mv_y_q_scale"} <= kept
    assert _port_names(tp.cast_params(copy.deepcopy(tmixed), BF16), F32) \
        == set()


@pytest.mark.parametrize("keep", [jp.RECON_F32_MODULES, ("optic_flow",),
                                  ("bit_estimator_z",)])
def test_engine_param_dtype_is_the_jax_first_leaf_rule(dmc, keep):
    """The engine's dtype for symbol planes and the DPB is that of the
    parameter whose flax path sorts first, as the JAX engine's
    tree_leaves(params)[0]; the keep sets tell it apart from the first
    registered parameter."""
    _, params, port = dmc
    jleaf = jax.tree_util.tree_leaves(jax.eval_shape(
        lambda p: jp.cast_params_mixed(p, keep), params))[0]
    tmodel = tp.cast_params_mixed(copy.deepcopy(port), keep)
    want = F32 if jleaf.dtype == jnp.float32 else BF16
    assert param_dtype(tmodel) == want


def test_cast_refreshes_the_kmajor_weight_cache():
    from vcm_ts_tpu_torch.ops.layers import SubpelConv

    m = SubpelConv(8, 4, 2, 1)
    assert m.kmajor_weights()[0].dtype == F32
    tp.cast_params(m, BF16)
    assert all(w.dtype == BF16 for w in m.kmajor_weights())


# ---------------------------------------------------------- per module, bf16
@pytest.mark.parametrize("case", ["subpel_k1", "subpel_k3", "se_layer",
                                  "resblock_bottleneck", "me_basic", "unet"])
def test_layers_bf16_and_promotion_match_jax(case):
    jmod_f, tmod_f, shape = LAYER_CASES[case]
    x = np.random.default_rng(len(case)).standard_normal(shape).astype(
        np.float32)
    jmod = jmod_f()
    tbase = init_params(tmod_f(), seed=2, kernel_scale=0.5).to(
        memory_format=torch.channels_last).eval()
    params = flax_params_like(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), tbase)
    apply = jax.jit(jmod.apply)
    # (params bf16, input bf16): all bf16, then the two promotions
    for pb, xb in ((True, True), (False, True), (True, False)):
        jparams = jp.cast_params(params, jnp.bfloat16) if pb else params
        want = apply(jparams, jnp.asarray(x, jnp.bfloat16 if xb
                                          else jnp.float32))
        tmod = copy.deepcopy(tbase)
        if pb:
            tp.cast_params(tmod, BF16)
        with torch.no_grad():
            got = tmod(nchw(x).to(BF16 if xb else F32))
        assert got.dtype == (BF16 if want.dtype == jnp.bfloat16 else F32)
        want = np.asarray(want.astype(jnp.float32))
        scale = float(np.abs(want).max())
        tol = 2.0 ** -5 if pb and xb else 1e-4
        np.testing.assert_allclose(nhwc(got.float()), want, rtol=0,
                                   atol=tol * scale,
                                   err_msg=f"params bf16 {pb}, x bf16 {xb}")


@pytest.mark.parametrize("name", ["bilinear_up2", "bilinear_down2",
                                  "avg_pool2"])
def test_resize_bf16_matches_jax(name):
    x = np.random.default_rng(3).random((1, 8, 12, 4)).astype(np.float32)
    want = np.asarray(getattr(jr, name)(jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))
    got = getattr(tr, name)(nchw(x).to(BF16))
    assert got.dtype == BF16
    # one bf16 ulp at values in [0, 1)
    np.testing.assert_allclose(nhwc(got.float()), want, rtol=0,
                               atol=2.0 ** -8)


def test_packed_warp_promotes_mixed_dtypes_like_jax():
    """A bf16 frame and an f32 feature in one packed warp both come out
    f32, as the JAX package's concatenation makes them."""
    rng = np.random.default_rng(4)
    frame = rng.random((1, 8, 12, 3)).astype(np.float32)
    feat = rng.standard_normal((1, 8, 12, 16)).astype(np.float32)
    flow = rng.normal(0, 3, (1, 8, 12, 2)).astype(np.float32)
    want = j_flow_warp_packed((jnp.asarray(frame, jnp.bfloat16),
                               jnp.asarray(feat)), jnp.asarray(flow))
    got = tw.flow_warp_packed((nchw(frame).to(BF16), nchw(feat)),
                              nchw(flow))
    for g, w in zip(got, want):
        assert g.dtype == F32 and w.dtype == jnp.float32
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0, atol=1e-6)


def test_entropy_bf16_tables_byte_equal_and_indexes(dmc):
    """z CDF tables from bf16 parameters are byte-equal (built on the CPU in
    f32); bf16 scales index in bf16 on both sides, to the same rows."""
    _, params, port = dmc
    jparams = jp.cast_params(params, jnp.bfloat16)
    tmodel = tp.cast_params(copy.deepcopy(port), BF16)
    for name in ("bit_estimator_z", "bit_estimator_z_mv"):
        want = jbe.build_table(jbe.BitEstimator(64),
                               {"params": jparams["params"][name]})
        got = tbe.build_table(getattr(tmodel, name))
        for f in ("cdf", "sizes", "offsets"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    scales = np.exp(np.random.default_rng(5).uniform(-6, 4.5, 4000)).astype(
        np.float32)
    want = np.asarray(JGaussianCoder("laplace").build_indexes(
        jnp.asarray(scales, jnp.bfloat16)))
    got = GaussianCoder("laplace").build_indexes(
        torch.from_numpy(scales).to(BF16)).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ one DMC frame
@pytest.mark.parametrize("policy", ["bf16", "mixed"])
def test_dmc_frame_bf16_and_mixed_match_jax(dmc, policy):
    jmodel, params, port = dmc
    rng = np.random.default_rng(6)
    ref = rng.random((1, 64, 64, 3)).astype(np.float32)
    x = np.clip(np.roll(ref, 2, axis=2) + 0.02 * rng.standard_normal(
        ref.shape), 0, 1).astype(np.float32)
    if policy == "bf16":
        jparams = jp.cast_params(params, jnp.bfloat16)
        tmodel = tp.cast_params(copy.deepcopy(port), BF16)
    else:
        jparams = jp.cast_params_mixed(params)
        tmodel = tp.cast_params_mixed(copy.deepcopy(port))
    want = jax.jit(jmodel.apply, static_argnames=("is_first_p",))(
        jparams, jnp.asarray(x, jnp.bfloat16),
        j_make_dpb(jnp.asarray(ref, jnp.bfloat16)), 0.7, 0.7,
        is_first_p=True)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x).to(BF16),
                     make_dpb(torch.from_numpy(ref).to(BF16)), 0.7, 0.7,
                     is_first_p=True)
    for k, v in want["dpb"].items():
        assert got["dpb"][k].dtype == (F32 if v.dtype == jnp.float32
                                       else BF16), k
    if policy == "mixed":
        assert got["dpb"]["ref_frame"].dtype == F32
    a = np_tree(got["dpb"]["ref_frame"].float())
    b = np.asarray(want["dpb"]["ref_frame"].astype(jnp.float32))
    psnr = -10 * np.log10(np.mean((a - b) ** 2) + 1e-12)
    print(f"{policy}: recon agreement {psnr:.2f} dB, bpp port "
          f"{float(got['bpp'][0]):.5f} jax {float(want['bpp'][0]):.5f}")
    assert psnr >= 35.0, psnr
    np.testing.assert_allclose(np_tree(got["bpp"].float()),
                               np.asarray(want["bpp"].astype(jnp.float32)),
                               rtol=0.02)


@pytest.mark.parametrize("policy", ["bf16", "mixed"])
def test_gop_decodes_to_the_encoder_recon(dmc, policy):
    """An I + 2 P GOP through the port's engines in bf16 and mixed: every
    decoded frame equals the encoder's recon bit for bit (the encoder runs
    the decoder's own stages in the same dtypes)."""
    cast = (partial(tp.cast_params, dtype=BF16) if policy == "bf16"
            else tp.cast_params_mixed)
    ic = IntraCodec(cast(make_intra("cpu")), device="cpu")
    vc = VideoCodec(cast(copy.deepcopy(dmc[2])), device="cpu")
    ic.update()
    vc.update()
    frames = [torch.from_numpy(f) for f in moving_frames(8, 3)]
    i_stream = ic.compress(frames[0], 0.5)
    r0 = ic.decompress(i_stream, 64, 64, 0.5)
    streams, _ = vc.encode_gop(frames[1:], make_dpb(r0), 0.7, 0.7)
    enc, dpb = [], make_dpb(r0)
    for t, x in enumerate(frames[1:]):
        dpb = vc.compress(x, dpb, 0.7, 0.7, is_first_p=t == 0)["dpb"]
        enc.append(dpb["ref_frame"])
    dec, _ = vc.decode_gop(make_dpb(ic.decompress(i_stream, 64, 64, 0.5)),
                           streams, 64, 64, 0.7, 0.7)
    assert r0.dtype == BF16 and all(d.dtype == BF16 for d in dec)
    for e, d in zip(enc, dec):
        assert torch.equal(e, d)


# --------------------------------------------------------------- port bench
@pytest.mark.parametrize("mode", [
    ["--estimate-only"], ["--gop", "2"], [], ["--write-stream"],
    ["--write-stream", "--streams", "2"],
    ["--pipelined-encode", "--streams", "2"],
    ["--pipelined-decode", "--streams", "2"]])
def test_port_bench_emits_bench_py_keys(mode, monkeypatch, capsys):
    """The port bench on the CPU prints one JSON line whose keys are those
    bench.py prints in the same mode (the default suite's
    write_stream_2x_aggregate_fps keys included). bench.py runs with its
    timed functions and its model init stubbed out (its keys do not depend
    on them)."""
    import bench as jbench
    from vcm_ts_tpu.utils import common as jcommon

    for fn in ("bench_estimation", "bench_pipelined_encode",
               "bench_pipelined_decode", "bench_batched_write",
               "bench_seq_write"):
        monkeypatch.setattr(jbench, fn, lambda ctx: 1.0)
    for fn in ("bench_pipelined_encode_multi", "bench_pipelined_decode_multi"):
        monkeypatch.setattr(jbench, fn, lambda ctx, n: 1.0)
    monkeypatch.setattr(jbench, "bench_gop", lambda ctx: (1.0, 1.0))
    monkeypatch.setattr(jcommon, "enable_compilation_cache", lambda: "")
    monkeypatch.setattr(JDMC, "init", lambda self, *a, **k: {
        "params": {"w": jnp.zeros((1,))}})
    args = ["--size", "64x64", "--frames", "2", "--runs", "1", *mode]
    monkeypatch.setattr(sys, "argv", ["bench.py", *args])
    jbench.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tbench.main(["--device", "cpu", "--warmup", "1", *args]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    assert "suite_error" not in got and got["value"] > 0


def test_port_bench_refuses_what_is_not_ported(monkeypatch):
    """Nothing of bench.py is refused any more: --train-step runs the
    train-step bench (stubbed here; tests/test_torch_train_step.py runs
    it), and only single-stream modes asked for two streams are refused;
    the serving modes run."""
    monkeypatch.setattr(tbench, "bench_train_step", lambda args: "train")
    assert tbench.run(tbench.parse_args(
        ["--device", "cpu", "--train-step"])) == "train"
    for flag in (["--latency"], ["--gop", "2"]):
        with pytest.raises(SystemExit, match="single-stream"):
            tbench.run(tbench.parse_args(["--device", "cpu", "--streams",
                                          "2", *flag]))
    for flag in (["--write-stream"], ["--write-stream", "--streams", "2"],
                 ["--pipelined-decode", "--streams", "2"],
                 ["--pipelined-encode", "--streams", "2"]):
        args = tbench.parse_args(["--device", "cpu", *flag])
        tbench._refuse(args, args.streams)
