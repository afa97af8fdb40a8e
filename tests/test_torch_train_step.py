"""PyTorch port, training slice: the RD loss, the steps, the stage
optimizer, the schedule and DCVC_HEM against the JAX package on the CPU.

A DMC at 16/16/24 with anchor_num 2 (as tests/test_train_step.py), on the
port's seeded damped init carried into the JAX model (`flax_params_like`),
64x64 frames made with numpy. Training noise: JAX's own draws (its key
split, replayed here) fed to the port. Gradients are compared name by
name through state_dict_from_flax (linear: transposes only).

Tolerances (f32): the loss and FrameAux rtol 1e-4; gradients rtol 1e-2
with an atol of 1e-2 of each leaf's largest magnitude. The port's CPU
convs (oneDNN, row by row) and XLA's sum in other orders, and a deep
net's backward through two UNets, the hyperprior and the BPTT chain
carries those last-ulp differences to a few 1e-3 of a leaf's scale where
the leaf's gradient is a small sum of cancelling terms (measured worst:
3e-3, the contextual hyperprior encoder's bias in the cascade, a leaf of
scale 2.4e-5 against 1e-2 elsewhere); a wrong rule (a lost 0.5 at a
clip, a missing gradient path, a transposed weight) moves a leaf by O(1)
of its scale. A step's gradients are read from the optimizer's first
moment, (1 - b1) g after one step, on both sides. The update itself is
held apart, on identical gradients: the port's StageOptimizer against
optax's adamw, atol 1e-7 (Adam's first step is lr g / (|g| + eps), a
sign for all but the smallest gradients, so parameters after a step on
two stacks' gradients differ by up to 2 lr wherever |g| is near eps).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_warp_twopass import (flax_params_like,  # noqa: F401
                                           one_torch_thread)
from vcm_ts_tpu.models.dmc import DMC as JDMC
from vcm_ts_tpu.models.dmc import make_dpb as j_make_dpb
from vcm_ts_tpu.models.wrapper import DCVC_HEM as JDCVC_HEM
from vcm_ts_tpu.train import train_step as jts
from vcm_ts_tpu.train.config import default_training_cfg as j_default_cfg
from vcm_ts_tpu.train.optimizer import make_stage_optimizer as j_make_opt
from vcm_ts_tpu.train.optimizer import trainable_mask as j_trainable_mask
from vcm_ts_tpu.train.stages import StageParams as JStageParams
from vcm_ts_tpu.train.stages import get_stage_params as j_get_stage_params
from vcm_ts_tpu.utils.common import tree_copy
from vcm_ts_tpu_torch.models.dmc import DMC, make_dpb
from vcm_ts_tpu_torch.models.wrapper import DCVC_HEM
from vcm_ts_tpu_torch.train import train_step as ts
from vcm_ts_tpu_torch.train.optimizer import (MODES, make_stage_optimizer,
                                              trainable_mask)
from vcm_ts_tpu_torch.train.stages import (StageParams, calc_max_epoch,
                                           get_stage_params)
from vcm_ts_tpu_torch.utils.config import default_training_cfg
from vcm_ts_tpu_torch.utils.weights import init_params, state_dict_from_flax

CH = (16, 16, 24)
LAMBDAS = [85.0, 170.0]
ALL_RATES = ("bpp_mv_y", "bpp_mv_z", "bpp_y", "bpp_z")
LR = 1e-4


def pl_fn(target, recon):
    """A perceptual term both stacks can call: per-row mean |t - r|."""
    return abs(target - recon).mean(axis=(1, 2, 3))


def _sequences(n=2, t=3, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.random((n, 1, 8, 8, 3)).astype(np.float32)
    frames = [np.kron(np.roll(base, k, axis=3),
                      np.ones((1, 1, 8, 8, 1)))[:, :, :64, :64, :]
              for k in range(t)]
    return np.concatenate(frames, axis=1).astype(np.float32)


def _stage(**kw):
    base = dict(stage=0, p_frames=1, trainable_mode="all",
                forward_method="single", loss_dist_key="mse",
                loss_rate_keys=ALL_RATES, lr=LR, perceptual_loss=False)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def models():
    """(JAX DMC, its params, the port DMC holding the same weights)."""
    port = init_params(DMC(anchor_num=2, channel_mv=CH[0], channel_N=CH[1],
                           channel_M=CH[2], device="cpu"), seed=0,
                       kernel_scale=0.5)
    jmodel = JDMC(anchor_num=2, channel_mv=CH[0], channel_N=CH[1],
                  channel_M=CH[2])
    x0 = jnp.zeros((2, 64, 64, 3))
    params = flax_params_like(
        lambda: jmodel.init(jax.random.PRNGKey(0), x0,
                            j_make_dpb(x0, CH[1], CH[2]), 1.0, 1.0,
                            method="init_all"), port)
    return jmodel, params, port


def jax_noise(key, shapes):
    """The draws the JAX DMC makes from noise_rng `key`."""
    ks = jax.random.split(key, 4)
    return tuple(torch.from_numpy(np.array(jax.random.uniform(
        k, s, jnp.float32, -0.5, 0.5))) for k, s in zip(ks, shapes))


def _named(tree):
    return {k: v.numpy() for k, v in state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _close_leaf(got, want, rtol=1e-2, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=name)


def _close_grads(got: dict, want: dict):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        _close_leaf(np.zeros_like(w) if g is None else g.numpy(), w,
                    name=name)


def _jax_mu(opt_state):
    """The JAX stage optimizer's first moment, by parameter name."""
    return _named(opt_state.inner_states["train"].inner_state[0].mu)


def _port_mu(opt):
    return {n: torch.from_numpy(m.numpy()) for n, m in opt.mu.items()}


def _port_loss(port, x, dpb, noise, **kw):
    kw = dict(dict(lambdas=torch.tensor(LAMBDAS), dist_lambda=1.0,
                   pl_lambda=0.5, loss_rate_keys=ALL_RATES,
                   loss_dist_key="mse", pl_fn=pl_fn, noise=noise,
                   is_first_p=True), **kw)
    return ts.frame_loss(port, x, x, dpb, **kw)


@pytest.fixture(scope="module")
def jax_frame_grad(models):
    """JAX's frame_loss value and gradient, called as (params, x, dpb, key,
    training). Both modes are traced here and compiled in threads (XLA
    works outside the interpreter lock) while the tests go on."""
    jmodel, params, _ = models

    def loss(p, x, dpb, key, training):
        return jts.frame_loss(
            p, jmodel, x, x, dpb, lambdas=jnp.asarray(LAMBDAS),
            dist_lambda=1.0, pl_lambda=0.5, loss_rate_keys=ALL_RATES,
            loss_dist_key="mse", pl_fn=pl_fn, noise_rng=key,
            is_first_p=True, training=training)

    fn = jax.jit(jax.value_and_grad(loss, has_aux=True),
                 static_argnums=(4,))
    x = jnp.zeros((2, 64, 64, 3))
    dpb = j_make_dpb(x, CH[1], CH[2])
    lowered = {True: fn.lower(params, x, dpb, jax.random.PRNGKey(0), True),
               False: fn.lower(params, x, dpb, None, False)}
    with ThreadPoolExecutor(2) as pool:
        compiled = {t: pool.submit(low.compile) for t, low in lowered.items()}
        yield lambda p, x, dpb, key, training: compiled[training].result()(
            p, x, dpb, key)


@pytest.mark.parametrize("training", [True, False])
def test_frame_loss_matches_jax(models, jax_frame_grad, training):
    """Loss, every FrameAux field, the DPB and every parameter's gradient;
    training with JAX's noise draws, and eval mode (rounding, no noise)."""
    _, params, port = models
    seqs = _sequences()
    key = jax.random.PRNGKey(5)
    x, ref = seqs[:, 1], seqs[:, 0]
    (jloss, (jaux, jdpb)), jgrads = jax_frame_grad(
        params, jnp.asarray(x), j_make_dpb(jnp.asarray(ref), CH[1], CH[2]),
        key if training else None, training)
    noise = jax_noise(key, port.noise_shapes(2, 64, 64)) if training \
        else None
    loss, (aux, dpb) = _port_loss(
        port, torch.from_numpy(x),
        make_dpb(torch.from_numpy(ref), CH[1], CH[2]), noise,
        training=training)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()),
                                allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-4)
    for f in ts.FrameAux._fields:
        np.testing.assert_allclose(getattr(aux, f).detach().numpy(),
                                   np.asarray(getattr(jaux, f)), rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    assert float(aux.p_dist.abs().sum()) > 0
    for k in jdpb:
        np.testing.assert_allclose(dpb[k].detach().numpy(),
                                   np.asarray(jdpb[k]), rtol=0, atol=1e-4,
                                   err_msg=k)
    _close_grads(dict(zip(names, grads)), _named(jgrads))


def test_single_step_matches_jax_adamw(models, jax_frame_grad):
    """make_single_frame_step: its gradients (the first moment) against the
    JAX frame_loss's, and the update: the port's AdamW applied to JAX's
    gradients gives optax's parameters and moments."""
    _, params, port0 = models
    port = copy.deepcopy(port0)
    seqs = _sequences(seed=1)
    key = jax.random.PRNGKey(8)
    x, ref = seqs[:, 1], seqs[:, 0]
    (_, (jaux, _)), jgrads = jax_frame_grad(
        params, jnp.asarray(x), j_make_dpb(jnp.asarray(ref), CH[1], CH[2]),
        key, True)
    tx, opt_state = j_make_opt(params, "all", LR)

    @jax.jit
    def update(g, state, p):
        u, state = tx.update(g, state, p)
        return optax.apply_updates(p, u), state

    jp, jstate = update(jgrads, opt_state, params)

    opt = make_stage_optimizer(port, "all", LR)
    step = ts.make_single_frame_step(port, opt, StageParams(**_stage()),
                                     lambdas=LAMBDAS, dist_lambda=1.0,
                                     pl_lambda=0.5, pl_fn=pl_fn)
    aux, new_dpb = step(torch.from_numpy(x), torch.from_numpy(x),
                        make_dpb(torch.from_numpy(ref), CH[1], CH[2]),
                        jax_noise(key, port.noise_shapes(2, 64, 64)), True)
    np.testing.assert_allclose(aux.loss.numpy(), np.asarray(jaux.loss),
                               rtol=1e-4)
    assert not any(v.requires_grad for v in new_dpb.values())
    _close_grads(_port_mu(opt), _jax_mu(jstate))

    same = copy.deepcopy(port0)
    opt = make_stage_optimizer(same, "all", LR)
    opt.step({n: torch.from_numpy(v) for n, v in _named(jgrads).items()})
    for name, v in _named(jp).items():
        np.testing.assert_allclose(
            dict(same.named_parameters())[name].detach().numpy(), v, rtol=0,
            atol=1e-7, err_msg=name)
    for name, v in _jax_mu(jstate).items():
        np.testing.assert_allclose(opt.mu[name].numpy(), v, rtol=1e-6,
                                   atol=1e-12, err_msg=name)


def test_inter_dist_step_leaves_frozen_parameters_bit_identical(models):
    """An inter_dist single step trains the motion path only: every frozen
    parameter is bit-identical afterwards (no decay, no moments)."""
    _, _, port0 = models
    port = copy.deepcopy(port0)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    opt = make_stage_optimizer(port, "inter_dist", LR)
    stage = StageParams(**_stage(trainable_mode="inter_dist",
                                 loss_dist_key="me_mse",
                                 loss_rate_keys=()))
    step = ts.make_single_frame_step(port, opt, stage, lambdas=LAMBDAS,
                                     dist_lambda=1.0, pl_lambda=0.0)
    seqs = _sequences(seed=2)
    gen = torch.Generator().manual_seed(0)
    ts.run_single_sequence(port, step, seqs, seqs, stage, gen)
    mask = trainable_mask(port, "inter_dist")
    for n, p in port.named_parameters():
        if mask[n]:
            assert not torch.equal(p, before[n]), n
        else:
            assert torch.equal(p, before[n]), n
    assert set(opt.mu) == {n for n, m in mask.items() if m}


def _cascade_noise(key, shapes, p_frames):
    """JAX's cascade key schedule: split per frame, then the DMC's 4."""
    out = []
    for _ in range(p_frames):
        key, sub = jax.random.split(key)
        out.append(jax_noise(sub, shapes))
    return out


def lower_cascade(models, accum):
    """The cascade case (p_frames 2) and JAX's cascade step (remat on;
    with accum_steps G, its per-group key schedule), traced here; what is
    left to run, later and in a thread, is XLA's compile and the step."""
    jmodel, params, port0 = models
    stage_kw = _stage(forward_method="cascade", p_frames=2)
    seqs = _sequences(t=3, seed=3)
    xs = np.stack([seqs[:, 1], seqs[:, 2]])
    key = jax.random.PRNGKey(11)
    tx, opt_state = j_make_opt(params, "all", LR)
    jstep = jts.make_cascade_step(jmodel, tx, JStageParams(**stage_kw),
                                  lambdas=LAMBDAS, dist_lambda=1.0,
                                  pl_lambda=0.5, pl_fn=pl_fn,
                                  accum_steps=accum)
    jargs = (tree_copy(params), tree_copy(opt_state), jnp.asarray(xs),
             jnp.asarray(xs), j_make_dpb(jnp.asarray(seqs[:, 0]), CH[1],
                                         CH[2]), key)
    lowered = jstep.lower(*jargs)
    return dict(accum=accum, stage_kw=stage_kw, seqs=seqs, xs=xs, key=key,
                run=lambda: lowered.compile()(*jargs))


@contextlib.contextmanager
def started_cascade(models, accum):
    """lower_cascade's case, its JAX step compiling and running in a
    thread (XLA works outside the interpreter lock) while the caller goes
    on; the case's "jax" is the step's future."""
    case = lower_cascade(models, accum)
    with ThreadPoolExecutor(1) as pool:
        case["jax"] = pool.submit(case.pop("run"))
        yield case


@pytest.fixture(scope="module", autouse=True)
def jax_cascade(models):
    """check_cascade's JAX step (accum 1), traced as the module's first
    test starts and compiled while the module's other tests run."""
    with started_cascade(models, 1) as case:
        yield case


def check_cascade(models, case):
    """make_cascade_step with p_frames 2 (BPTT through the DPB) against
    JAX's cascade step (remat on) with the same noise (with accum_steps G,
    JAX's per-group key schedule): FrameAux, the last DPB, the gradients;
    with accum_steps 1 also remat on against remat off in the port.
    `case` is started_cascade's."""
    _, _, port0 = models
    accum, stage_kw, seqs, xs, key = (case[k] for k in (
        "accum", "stage_kw", "seqs", "xs", "key"))
    if accum == 1:
        noises = _cascade_noise(key, port0.noise_shapes(2, 64, 64), 2)
    else:
        noises = [_cascade_noise(k, port0.noise_shapes(1, 64, 64), 2)
                  for k in jax.random.split(key, accum)]
    ran = {}
    for remat in ((False, True) if accum == 1 else (True,)):
        port = copy.deepcopy(port0)
        opt = make_stage_optimizer(port, "all", LR)
        step = ts.make_cascade_step(port, opt, StageParams(**stage_kw),
                                    lambdas=LAMBDAS, dist_lambda=1.0,
                                    pl_lambda=0.5, pl_fn=pl_fn,
                                    remat=remat, accum_steps=accum)
        aux, dpb = step(torch.from_numpy(xs), torch.from_numpy(xs),
                        make_dpb(torch.from_numpy(seqs[:, 0]), CH[1],
                                 CH[2]), noises)
        ran[remat] = (port, opt, aux, dpb)
    _, jstate, jaux, jdpb = case["jax"].result()
    want = _jax_mu(jstate)
    results = {}
    for remat, (port, opt, aux, dpb) in ran.items():
        for f in ts.FrameAux._fields:
            np.testing.assert_allclose(
                getattr(aux, f).numpy(), np.asarray(getattr(jaux, f)),
                rtol=1e-4, atol=1e-6, err_msg=f)
        np.testing.assert_allclose(dpb["ref_frame"].numpy(),
                                   np.asarray(jdpb["ref_frame"]), atol=1e-4)
        _close_grads(_port_mu(opt), want)
        results[remat] = {n: p.detach().clone() for n, p in
                          port.named_parameters()}
    if accum == 1:
        # remat replays the same ops: the same update
        for n, p in results[True].items():
            torch.testing.assert_close(p, results[False][n], rtol=0,
                                       atol=1e-7, msg=n)


def test_cascade_step_matches_jax_and_remat(models, jax_cascade):
    check_cascade(models, jax_cascade)


def test_mixed_precision_keeps_f32_masters(models):
    """compute_dtype=bf16: the loss is within rtol 5e-2 of f32 (as
    tests/test_train_step.py allows), the bit estimators run f32, and a
    step leaves every master parameter and moment f32."""
    _, _, port0 = models
    port = copy.deepcopy(port0)
    seqs = _sequences(seed=4)
    x = torch.from_numpy(seqs[:, 1])
    dpb = make_dpb(torch.from_numpy(seqs[:, 0]), CH[1], CH[2])
    noise = ts.draw_noise(port, x, torch.Generator().manual_seed(0))
    l32, _ = _port_loss(port, x, dpb, noise)
    l16, (aux16, dpb16) = _port_loss(port, x, dpb, noise,
                                     compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(float(l16), float(l32), rtol=5e-2)
    assert all(v.dtype == torch.float32 for v in dpb16.values())
    assert aux16.loss.dtype == torch.float32
    opt = make_stage_optimizer(port, "all", LR)
    step = ts.make_single_frame_step(
        port, opt, StageParams(**_stage()), lambdas=LAMBDAS, dist_lambda=1.0,
        pl_lambda=0.0, compute_dtype=torch.bfloat16)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    step(x, x, dpb, noise, True)
    for n, p in port.named_parameters():
        assert p.dtype == torch.float32 and opt.mu[n].dtype == torch.float32
        assert not torch.equal(p, before[n]), n


# ------------------------------------------------- schedule and freezing
def test_stage_schedule_matches_jax():
    cfg, jcfg = default_training_cfg(), j_default_cfg()
    assert json.dumps(cfg, sort_keys=True) == json.dumps(jcfg,
                                                         sort_keys=True)
    assert calc_max_epoch(cfg.SOLVER.STAGES) == 30
    for epoch in range(30):
        assert (dataclasses.asdict(get_stage_params(cfg, epoch))
                == dataclasses.asdict(j_get_stage_params(jcfg, epoch)))
    with pytest.raises(ValueError):
        get_stage_params(cfg, 30)
    cfg.SOLVER.STAGES = [["1", "me", "single", "me", "all", "1e-4", "1",
                          "false"]]
    with pytest.raises(ValueError, match="modules/loss-rate"):
        get_stage_params(cfg, 0)


@pytest.mark.parametrize("mode", MODES)
def test_trainable_mask_matches_jax(models, mode):
    _, params, port = models
    jmask = j_trainable_mask(params, mode)
    want = {n: bool(v.reshape(-1)[0]) for n, v in _named(
        jax.tree_util.tree_map(lambda m, p: np.full(p.shape, m), jmask,
                               params)).items()}
    assert trainable_mask(port, mode) == want
    with pytest.raises(ValueError):
        trainable_mask(port, "everything")


def test_grad_clip_matches_optax():
    """clip_by_global_norm before AdamW, on a toy tree, both sides."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    g = (10 * rng.standard_normal((4, 3))).astype(np.float32)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(LR, b1=0.9, b2=0.99, weight_decay=0.01))
    state = tx.init({"w": jnp.asarray(w)})
    p = {"w": jnp.asarray(w)}
    for _ in range(2):
        u, state = tx.update({"w": jnp.asarray(g)}, state, p)
        p = optax.apply_updates(p, u)
    lin = torch.nn.Linear(3, 4, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
    opt = make_stage_optimizer(lin, "all", LR, grad_clip_norm=1.0)
    for _ in range(2):
        opt.step({"weight": torch.from_numpy(g)})
    np.testing.assert_allclose(lin.weight.detach().numpy(),
                               np.asarray(p["w"]), rtol=0, atol=1e-7)


# --------------------------------------------------------------- wrapper
@pytest.fixture(scope="module")
def wrapper(models):
    _, _, port = models
    cfg = default_training_cfg()
    cfg.MODEL.CHANNELS = list(CH)
    cfg.SOLVER.LAMBDAS = [85, 170]
    return DCVC_HEM(cfg, model=copy.deepcopy(port), device="cpu")


def test_wrapper_activations_and_lr(wrapper):
    for mode in MODES:
        getattr(wrapper, f"activate_modules_{mode}")()
        assert wrapper._mode == mode
        assert set(wrapper._opt.names) == {
            n for n, m in trainable_mask(wrapper.dmc, mode).items() if m}
    opt = wrapper._opt
    wrapper.set_lr(5e-5)
    assert wrapper._opt is not opt and wrapper._opt.lr == 5e-5
    wrapper.set_lr(LR)


def test_wrapper_single_method_trains(wrapper):
    wrapper.activate_modules_inter_dist()
    seqs = _sequences()
    name = "optic_flow.moduleBasic.0.conv1.weight"
    before = dict(wrapper.dmc.named_parameters())[name].detach().clone()
    out = wrapper("single", seqs, seqs, loss_dist_key="me_mse",
                  loss_rate_keys=[], p_frames=1, perceptual_loss=False)
    assert out["loss"].shape == (2, 2)  # (anchors, (T - p) * p)
    assert out["single_forwards"] == 2
    after = dict(wrapper.dmc.named_parameters())[name]
    assert not torch.allclose(before, after)
    out = wrapper("cascade", seqs, seqs, loss_dist_key="mse",
                  loss_rate_keys=ALL_RATES, p_frames=2,
                  perceptual_loss=False)
    assert out["loss"].shape == (2, 1) and np.isfinite(out["loss"]).all()


def test_wrapper_multi_and_simple(wrapper):
    seqs = _sequences(t=3, seed=1)
    dpb = make_dpb(torch.from_numpy(seqs[:, 0]), CH[1], CH[2])
    out = wrapper("cascade_multi", seqs, seqs, loss_dist_key="mse",
                  loss_rate_keys=["bpp_y", "bpp_z"], p_frames=2, t_i=0,
                  perceptual_loss=False, dpb=dpb)
    assert out["loss"].shape == (2,)
    assert np.isfinite(float(out["loss_to_opt"]))
    assert out["loss_to_opt"].requires_grad
    assert out["dpb"]["ref_frame"].shape == (2, 64, 64, 3)
    out = wrapper("single_multi", seqs[:, 1], seqs[:, 1],
                  loss_dist_key="mse", loss_rate_keys=ALL_RATES, dpb=dpb,
                  perceptual_loss=False)
    assert out["loss"].shape == (2,) and not out["dpb"]["ref_y"].requires_grad
    dpbs = [make_dpb(torch.from_numpy(seqs[i:i + 1, 0]), CH[1], CH[2])
            for i in range(2)]
    res = wrapper("forward_simple", seqs[:, 1], dpb=dpbs)
    assert len(res) == 2 and res[0]["ref_frame"].shape == (1, 64, 64, 3)
    with pytest.raises(ValueError):
        wrapper("sideways", seqs)


def test_wrapper_eval_matches_jax_wrapper(models):
    """The eval path (is_train=False, an I-frame callable) of both
    wrappers on the same weights."""
    _, params, port = models
    cfg, jcfg = default_training_cfg(), j_default_cfg()
    for c in (cfg, jcfg):
        c.MODEL.CHANNELS = list(CH)
        c.SOLVER.LAMBDAS = [85, 170]
    tw = DCVC_HEM(cfg, model=copy.deepcopy(port), device="cpu",
                  pl_fn=pl_fn)
    jw = JDCVC_HEM(jcfg, params=params, pl_fn=pl_fn)
    seqs = _sequences(t=3, seed=5)

    def i_frame(x):
        return np.clip(np.asarray(x) * 0.9 + 0.05, 0, 1)

    kw = dict(loss_dist_key="mse", loss_rate_keys=list(ALL_RATES),
              p_frames=2, perceptual_loss=True, is_train=False,
              i_frame_net=i_frame)
    got = tw("cascade", seqs, seqs, **kw)
    want = jw("cascade", seqs, seqs, **kw)
    assert got["single_forwards"] == want["single_forwards"] == 2
    for k in ("rate", "dist", "p_dist", "loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
