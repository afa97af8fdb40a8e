"""PyTorch port, training slice: the gradient rules and the backward
kernels' plain versions against jax.vjp of the JAX package's functions.

- `lower_bound`'s custom VJP, `quant_ste`, `add_uniform_noise`
  (vcm_ts_tpu/ops/math.py);
- kernel A' (`warp_backward_plain`, and the autograd path through
  `flow_warp` / `flow_warp_packed`) against jax.vjp of the exact warp,
  3 + 64 channels packed, under an iid N(0, 8^2) flow, a zero flow (jnp.clip's
  0.5 at a bound), an integer flow, a flow beyond the border and a
  converging one (every output onto one pixel); f32,
  rtol 1e-5 with an atol of 1e-5 of the largest magnitude (the sums run in
  other orders: XLA's scatter against index_add_);
- kernel C' (`space_to_depth_plain`) equal to `_kmajor_space_to_depth`
  bit for bit;
- kernels B and C through autograd against jax.vjp of `subpel_conv1x1` /
  `pixel_shuffle_relayout` in interpret mode (f32, rtol 1e-5);
- a SubpelConv's parameter gradients (kernel 1 and 3) against the JAX
  layer's, with and without its fast shuffle;
- gradient accumulation: a cascade step with accum_steps 2 against JAX's
  (tests/test_torch_train_step.py's check, its tolerances);
- the port bench's --train-step on the CPU;
- the stage optimizer's update of a channels_last weight against optax's
  adamw.
(The last three live here to keep each file's run short: the JAX side of a
cascade case compiles for about 45 s on a CPU.)
The CUDA kernels are held to these plain versions on the card
(tests/test_torch_train_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_train_step import (LR, check_cascade,  # noqa: F401
                                         models, started_cascade)
from tests.test_torch_warp_twopass import one_torch_thread  # noqa: F401
from tests.torch_port_util import nchw, nhwc
from vcm_ts_tpu.ops import layers as j_layers
from vcm_ts_tpu.ops import math as j_math
from vcm_ts_tpu.ops import subpel_pallas as j_subpel
from vcm_ts_tpu.ops import warp as j_warp
from vcm_ts_tpu_torch import bench as tbench
from vcm_ts_tpu_torch.ops import math as t_math
from vcm_ts_tpu_torch.ops import subpel as t_subpel
from vcm_ts_tpu_torch.ops import warp as t_warp
from vcm_ts_tpu_torch.ops.layers import SubpelConv
from vcm_ts_tpu_torch.train.optimizer import make_stage_optimizer
from vcm_ts_tpu_torch.utils.weights import state_dict_from_flax


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _leaf(x):
    return torch.from_numpy(np.array(x, np.float32)).requires_grad_()


# ----------------------------------------------------------- ops/math.py
def test_lower_bound_vjp_matches_jax():
    """x below, at and above the bound, g of both signs."""
    x = np.array([-1.0, 0.2, 0.5, 0.5, 0.7, 3.0, -2.0, 0.49999],
                 np.float32)
    g = np.array([1.0, -1.0, 1.0, -1.0, 2.0, -3.0, -0.5, 0.25], np.float32)
    out, vjp = jax.vjp(lambda v: j_math.lower_bound(v, 0.5), jnp.asarray(x))
    tx = _leaf(x)
    y = t_math.lower_bound(tx, 0.5)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(tx.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))
    # the rule itself: passes where x >= bound or g < 0
    np.testing.assert_array_equal(
        tx.grad.numpy() != 0, (x >= 0.5) | (g < 0))
    # without a recorded gradient it is the clamp the codec ran before
    with torch.no_grad():
        np.testing.assert_array_equal(
            t_math.lower_bound(torch.from_numpy(x), 0.5).numpy(),
            torch.clamp_min(torch.from_numpy(x), 0.5).numpy())


def test_quant_ste_and_uniform_noise_match_jax():
    x = np.array([-1.5, -0.5, 0.5, 1.5, 2.5, 0.3, -0.7, 2.49], np.float32)
    g = np.linspace(-1, 1, x.size).astype(np.float32)
    out, vjp = jax.vjp(j_math.quant_ste, jnp.asarray(x))
    tx = _leaf(x)
    y = t_math.quant_ste(tx)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(tx.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))
    # add_uniform_noise: JAX's draw fed in; no gradient to the noise
    key = jax.random.PRNGKey(3)
    want, vjp = jax.vjp(lambda v: j_math.add_uniform_noise(v, key),
                        jnp.asarray(x))
    noise = np.asarray(jax.random.uniform(key, x.shape, jnp.float32, -0.5,
                                          0.5))
    tx = _leaf(x)
    tn = _leaf(noise)
    y = t_math.add_uniform_noise(tx, tn)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(tx.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))
    assert tn.grad is None
    # the torch draw is U(-0.5, 0.5) of the asked shape and dtype
    gen = torch.Generator().manual_seed(0)
    u = t_math.uniform_noise((4, 8, 8, 3), gen, torch.bfloat16)
    assert u.shape == (4, 8, 8, 3) and u.dtype == torch.bfloat16
    assert float(u.float().min()) >= -0.5 and float(u.float().max()) <= 0.5


# ------------------------------------------------------ kernel A' (warp)
def _flow(kind, n, h, w, rng):
    if kind == "iid":
        return rng.normal(0, 8, (n, h, w, 2)).astype(np.float32)
    if kind == "zero":
        return np.zeros((n, h, w, 2), np.float32)
    if kind == "integer":
        return rng.integers(-3, 4, (n, h, w, 2)).astype(np.float32)
    if kind == "converge":
        # every output onto one interior pixel, at a fraction (so that all
        # four taps take weight)
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        f = np.stack([w // 3 + 0.25 - xs, h // 2 + 0.5 - ys], -1)
        return np.broadcast_to(f, (n, h, w, 2)).copy()
    # beyond the border: most samples clamp, some land exactly on it
    f = rng.normal(0, 3 * max(h, w), (n, h, w, 2)).astype(np.float32)
    f[:, ::3, ::2, 0] = -np.arange(w, dtype=np.float32)[::2]
    return f


FLOWS = ("iid", "zero", "integer", "beyond", "converge")


@pytest.mark.parametrize("kind", FLOWS)
def test_warp_backward_plain_matches_jax_vjp(kind):
    """flow_warp_packed((frame 3ch, feature 64ch), flow): d frame,
    d feature and d flow against jax.vjp; the same through autograd."""
    rng = np.random.default_rng(FLOWS.index(kind))
    n, h, w = 2, 12, 17
    frame = rng.random((n, h, w, 3)).astype(np.float32)
    feat = rng.standard_normal((n, h, w, 64)).astype(np.float32)
    flow = _flow(kind, n, h, w, rng)
    g3 = rng.standard_normal((n, h, w, 3)).astype(np.float32)
    g64 = rng.standard_normal((n, h, w, 64)).astype(np.float32)

    _, vjp = jax.vjp(lambda a, b, f: j_warp.flow_warp_packed((a, b), f),
                     jnp.asarray(frame), jnp.asarray(feat),
                     jnp.asarray(flow))
    want_frame, want_feat, want_flow = (
        np.asarray(v) for v in vjp([jnp.asarray(g3), jnp.asarray(g64)]))

    ims = [nchw(frame), nchw(feat)]
    dflow, (d3, d64) = t_warp.warp_backward_plain(
        ims, nchw(flow), [nchw(g3), nchw(g64)])
    _close(nhwc(d3), want_frame)
    _close(nhwc(d64), want_feat)
    _close(nhwc(dflow), want_flow)
    if kind == "zero":
        # the clip's 0.5 at x + u == 0 and == W - 1 (and at the rows)
        _, vjp1 = jax.vjp(lambda f: j_warp.flow_warp(jnp.asarray(feat), f),
                          jnp.asarray(flow))
        full = np.asarray(vjp1(jnp.asarray(g64))[0])
        assert np.all(full[:, :, w - 1, 0] == 0)
        assert np.any(full[:, :, 0, 0] != 0)

    # autograd: flow_warp_packed on leaves, then backward
    ta, tb, tf = (t.requires_grad_() for t in
                  (nchw(frame).clone(), nchw(feat).clone(),
                   nchw(flow).clone()))
    outs = t_warp.flow_warp_packed((ta, tb), tf)
    torch.autograd.backward(outs, [nchw(g3), nchw(g64)])
    _close(nhwc(ta.grad), want_frame)
    _close(nhwc(tb.grad), want_feat)
    _close(nhwc(tf.grad), want_flow)


def test_warp_backward_flow_only_and_single_tensor():
    """A reference frame that takes no gradient: d flow alone (no d im
    pass), flow_warp of one tensor, against jax.vjp."""
    rng = np.random.default_rng(7)
    im = rng.random((1, 9, 14, 3)).astype(np.float32)
    flow = rng.normal(0, 2, (1, 9, 14, 2)).astype(np.float32)
    g = rng.standard_normal((1, 9, 14, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda f: j_warp.flow_warp(jnp.asarray(im), f),
                     jnp.asarray(flow))
    tf = nchw(flow).clone().requires_grad_()
    t_warp.flow_warp(nchw(im), tf).backward(nchw(g))
    _close(nhwc(tf.grad), np.asarray(vjp(jnp.asarray(g))[0]))
    dflow, dims = t_warp.warp_backward_plain([nchw(im)], nchw(flow),
                                             [nchw(g)], need_im=False)
    assert dims == [None]
    np.testing.assert_array_equal(nhwc(dflow), nhwc(tf.grad))


# --------------------------------------------------- kernels C, C' and B
@pytest.mark.parametrize("c,h,w,r", [(8, 5, 7, 2), (3, 4, 6, 2),
                                     (2, 3, 3, 3)])
def test_space_to_depth_plain_equals_jax_bitwise(c, h, w, r):
    rng = np.random.default_rng(c * h)
    g = rng.standard_normal((2, h * r, w * r, c)).astype(np.float32)
    want = np.asarray(j_subpel._kmajor_space_to_depth(jnp.asarray(g), r))
    got = t_subpel.space_to_depth_plain(nchw(g), r)
    np.testing.assert_array_equal(nhwc(got), want)
    # and it inverts the depth-to-space
    np.testing.assert_array_equal(
        nhwc(t_subpel.relayout_plain(got, r)), g)


def test_relayout_autograd_matches_jax_vjp():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 6, 5, 4 * 16)).astype(np.float32)
    g = rng.standard_normal((2, 12, 10, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: j_subpel.pixel_shuffle_relayout(
        v, 2, interpret=True), jnp.asarray(x))
    tx = nchw(x).clone().requires_grad_()
    t_subpel.pixel_shuffle_relayout(tx, 2).backward(nchw(g))
    np.testing.assert_array_equal(nhwc(tx.grad),
                                  np.asarray(vjp(jnp.asarray(g))[0]))


@pytest.mark.parametrize("cin,c", [(16, 8), (24, 2)])
def test_subpel_conv1x1_autograd_matches_jax_vjp(cin, c):
    rng = np.random.default_rng(cin + c)
    x = rng.standard_normal((2, 5, 6, cin)).astype(np.float32)
    wk = (rng.standard_normal((4, cin, c)) / cin ** 0.5).astype(np.float32)
    bk = rng.standard_normal((4, c)).astype(np.float32)
    g = rng.standard_normal((2, 10, 12, c)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, d: j_subpel.subpel_conv1x1(
        a, b, d, 2, interpret=True), *map(jnp.asarray, (x, wk, bk)))
    dx, dw, db = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    tx = nchw(x).clone().requires_grad_()
    tw, tb = _leaf(wk), _leaf(bk)
    y = t_subpel.subpel_conv1x1(tx, tw, tb, 2)
    _close(nhwc(y), np.asarray(out))
    y.backward(nchw(g))
    _close(nhwc(tx.grad), dx)
    _close(tw.grad.numpy(), dw)
    _close(tb.grad.numpy(), db)


@pytest.mark.parametrize("kernel", [1, 3])
@pytest.mark.parametrize("fast", [False, True])
def test_subpel_conv_parameter_grads_match_jax(kernel, fast):
    """SubpelConv's gradients reach child conv "0" (c-major), equal to the
    JAX layer's kernel/bias gradients carried through state_dict_from_flax
    (a transpose); the JAX layer with and without its fast shuffle."""
    rng = np.random.default_rng(kernel + 2 * fast)
    cin, f = 12, 6
    x = rng.standard_normal((2, 5, 7, cin)).astype(np.float32)
    g = rng.standard_normal((2, 10, 14, f)).astype(np.float32)
    jmod = j_layers.SubpelConv(f, 2, kernel)
    j_layers.set_fast_shuffle(fast)
    try:
        params = jmod.init(jax.random.PRNGKey(kernel), jnp.asarray(x))
        params = jax.tree_util.tree_map(
            lambda v: v + 0.01 * jnp.arange(v.size, dtype=v.dtype).reshape(
                v.shape) / v.size, params)
        out, vjp = jax.vjp(lambda p, v: jmod.apply(p, v), params,
                           jnp.asarray(x))
        dparams, dx = vjp(jnp.asarray(g))
    finally:
        j_layers.set_fast_shuffle(False)
    port = SubpelConv(cin, f, 2, kernel)
    port.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    tx = nchw(x).clone().requires_grad_()
    y = port(tx)
    _close(nhwc(y), np.asarray(out))
    y.backward(nchw(g))
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, dparams))
    got = dict(port.named_parameters())
    assert set(want) == set(got)
    for name, v in want.items():
        _close(got[name].grad.numpy(), v.numpy())
    _close(nhwc(tx.grad), np.asarray(dx))


def test_fast_warp_refuses_a_gradient():
    from vcm_ts_tpu_torch.ops.warp_twopass import flow_warp_twopass

    im = torch.rand(1, 3, 8, 8).requires_grad_()
    flow = torch.zeros(1, 2, 8, 8)
    with pytest.raises(RuntimeError, match="no backward"):
        flow_warp_twopass(im, flow, 4)
    with torch.no_grad():
        assert flow_warp_twopass(im, flow, 4).shape == im.shape


# ----------------------------------------------------- accumulation, bench
@pytest.fixture(scope="module", autouse=True)
def jax_cascade_accum(models):  # noqa: F811
    """check_cascade's JAX step with accum_steps 2, traced as the module's
    first test starts and compiled while the module's other tests run."""
    with started_cascade(models, 2) as case:
        yield case


def test_cascade_grad_accum_matches_jax(models,  # noqa: F811
                                        jax_cascade_accum):
    check_cascade(models, jax_cascade_accum)


# ------------------------------------------------------------------ bench
def test_port_bench_train_step_prints_its_json_line(capsys):
    """python -m vcm_ts_tpu_torch.bench --device cpu --size 64x64
    --train-step: one JSON line with bench.py's keys (the DMC at its
    published widths; one frame per chain and no warm-up to stay short)."""
    assert tbench.main(["--device", "cpu", "--size", "64x64",
                        "--train-step", "--p-frames", "1", "--warmup", "0",
                        "--frames", "0"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "vs_baseline"} <= set(line)
    assert line["unit"] == "frames/s" and line["value"] > 0
    assert line["steps"] == 4 and np.isfinite(line["loss"]).all()


def test_adamw_pairs_gradients_with_channels_last_weights():
    """A channels_last conv weight stepped with a gradient in the default
    layout (as a summed or accumulated gradient may come) matches optax's
    adamw on the same values: the multi-tensor update must not pair
    elements by memory order across layouts."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((8, 4, 3, 3)).astype(np.float32)
    g = rng.standard_normal((8, 4, 3, 3)).astype(np.float32)
    tx = optax.adamw(LR, b1=0.9, b2=0.99, weight_decay=0.01)
    p = {"w": jnp.asarray(w)}
    u, _ = tx.update({"w": jnp.asarray(g)}, tx.init(p), p)
    want = np.asarray(optax.apply_updates(p, u)["w"])
    conv = torch.nn.Conv2d(4, 8, 3, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
    conv = conv.to(memory_format=torch.channels_last)
    opt = make_stage_optimizer(conv, "all", LR)
    opt.step({"weight": torch.from_numpy(g)})
    assert conv.weight.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(conv.weight.detach().numpy(), want, rtol=0,
                               atol=1e-7)
