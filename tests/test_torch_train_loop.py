"""PyTorch port, training loop: vcm_ts_tpu_torch/train/train_loop.do_train
and eval/validation against the JAX package's on the CPU.

The curriculum of tests/test_trainer_cli.py: DMC 16/16/24 with 2 rate
anchors (85, 170), two PNG sequences of 3 frames at 64x64 read 2 at a
time (SEQUENCE_LENGTH 2) through both packages' loaders (bit-equal
batches, tests/test_torch_data.py), stages `me/single` then
`all/cascade` (p_frames 1), one epoch each, eval on the same sequences
after each epoch. The port's seeded damped init is carried into the JAX
model (`flax_params_like`). Training noise: JAX's own draws along JAX's
key splits (one split per iteration in do_train, then per frame, or per
chain and frame), patched into the port's draw functions.

Tolerances: every logged train and eval metric rtol 1e-4, and each
step's gradients (the port's as its optimizer gets them, JAX's from its
optimizer's first moment) rtol 1e-2 with an atol of 1e-2 of the leaf's
largest: tests/test_torch_train_step.py's for a step. The final
parameters: each element's change from the common start equals JAX's
within the difference that the two stacks' gradients make in AdamW's
update, plus the rounding (`_change_atol`), wherever JAX's gradient at
each step is further from 0 than twice the stacks' gap (93 % of the
trained elements). A flipped update, or a leaf trained in a stage that
freezes it (its weight decay alone, 1e-6 p), fails this check.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_train_step import _close_leaf, _jax_mu
from tests.test_torch_warp_twopass import (flax_params_like,  # noqa: F401
                                           one_torch_thread)
from vcm_ts_tpu import data as jdata
from vcm_ts_tpu.models.dmc import DMC as JDMC
from vcm_ts_tpu.models.dmc import make_dpb as j_make_dpb
from vcm_ts_tpu.train.checkpoint import CheckPointer as JCheckPointer
from vcm_ts_tpu.train.config import default_training_cfg as j_cfg
from vcm_ts_tpu.train.tensorboard import MetricWriter as JMetricWriter
from vcm_ts_tpu.train.train_loop import do_train as j_do_train
from vcm_ts_tpu.eval.validation import \
    eval_object_detection as j_eval_object_detection
from vcm_ts_tpu.utils.weight_export import save_torch_state_dict
from vcm_ts_tpu_torch import data as tdata
from vcm_ts_tpu_torch.eval.validation import eval_object_detection
from vcm_ts_tpu_torch.models.dmc import DMC, make_dpb
from vcm_ts_tpu_torch.train import train_step as ts
from vcm_ts_tpu_torch.train.checkpoint import CheckPointer
from vcm_ts_tpu_torch.train.optimizer import StageOptimizer
from vcm_ts_tpu_torch.train.tensorboard import MetricWriter
from vcm_ts_tpu_torch.train.train_loop import do_train
from vcm_ts_tpu_torch.utils.config import default_training_cfg as t_cfg
from vcm_ts_tpu_torch.utils.weights import init_params, state_dict_from_flax

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CH = (16, 16, 24)
LAMBDAS = [85.0, 170.0]
LR = 1e-4
STAGES = [["1", "me", "single", "me", "none", "0.0001", "1", "false"],
          ["1", "all", "cascade", "rec", "all", "0.0001", "1", "false"]]
STEPS = 2  # optimizer steps: one a stage
B1, EPS = 0.9, 1e-8  # AdamW's


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    rng = np.random.default_rng(0)
    for s in range(2):
        d = root / "g" / f"seq{s}" / "raw"
        os.makedirs(d)
        base = rng.random((9, 9, 3))
        for t in range(3):
            img = np.kron(np.roll(base, t, axis=1), np.ones((8, 8, 1)))[:64,
                                                                         :64]
            Image.fromarray((img * 255).astype(np.uint8)).save(
                d / f"{t:05d}.png")
    return root


def _cfg(make, tree, out):
    cfg = make()
    cfg.MODEL.CHANNELS = list(CH)
    cfg.DATASET.TYPE = "SequenceDataset"
    cfg.DATASET.TRAIN_ROOT_DIRS = [str(tree)]
    cfg.DATASET.TRAIN_SUBDIR_LISTS = [""]
    cfg.DATASET.TEST_ROOT_DIRS = [str(tree)]
    cfg.DATASET.TEST_SUBDIR_LISTS = [""]
    cfg.DATASET.SEQUENCE_LENGTH = 2
    cfg.INPUT.IMAGE_SIZE = [64, 64]
    cfg.SOLVER.LAMBDAS = list(LAMBDAS)
    cfg.SOLVER.STAGES = [list(s) for s in STAGES]
    cfg.OUTPUT_DIR = str(out)
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def models():
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


def _jax_noise(key, shapes):
    ks = jax.random.split(key, 4)
    return tuple(torch.from_numpy(np.array(jax.random.uniform(
        k, s, jnp.float32, -0.5, 0.5))) for k, s in zip(ks, shapes))


def patch_jax_noise(monkeypatch, seed):
    """Replay the JAX loop's key splits in the port's draws."""
    state = {"rng": jax.random.PRNGKey(seed), "key": None}
    single, cascade = ts.run_single_sequence, ts.run_cascade_sequence

    def per_iteration(fn):
        def run(*a, **k):
            state["rng"], state["key"] = jax.random.split(state["rng"])
            return fn(*a, **k)
        return run

    def draw_noise(model, x, generator, mesh=None):
        assert mesh is None
        state["key"], sub = jax.random.split(state["key"])
        return _jax_noise(sub, model.noise_shapes(*x.shape[:3]))

    def draw_cascade_noise(model, xs, generator, accum_steps=1, mesh=None):
        assert accum_steps == 1 and mesh is None
        state["key"], key = jax.random.split(state["key"])
        out = []
        for x in xs:
            key, sub = jax.random.split(key)
            out.append(_jax_noise(sub, model.noise_shapes(*x.shape[:3])))
        return out

    monkeypatch.setattr(ts, "run_single_sequence", per_iteration(single))
    monkeypatch.setattr(ts, "run_cascade_sequence", per_iteration(cascade))
    monkeypatch.setattr(ts, "draw_noise", draw_noise)
    monkeypatch.setattr(ts, "draw_cascade_noise", draw_cascade_noise)


def _jsonl(path):
    with open(path) as f:
        return {(e["tag"], e["step"]): e["value"]
                for e in map(json.loads, f)}


def test_do_train_matches_jax(tmp_path, tree, models, monkeypatch):
    import copy

    jmodel, params, port0 = models
    jcfg = _cfg(j_cfg, tree, tmp_path / "jax")
    tcfg = _cfg(t_cfg, tree, tmp_path / "port")
    jopt = _OptStates()
    # XLA compiles and runs JAX's steps outside the interpreter lock, so
    # its run overlaps the port's below
    pool = ThreadPoolExecutor(1)
    jax_run = pool.submit(
        j_do_train, jcfg, jmodel, params, jdata.make_data_loader(jcfg, 0),
        jopt, seed=0,
        test_loader=jdata.make_data_loader(jcfg, 0, is_train=False),
        writer=JMetricWriter(jcfg.OUTPUT_DIR, enable_tb=False))

    port = copy.deepcopy(port0)
    patch_jax_noise(monkeypatch, 0)
    grads = []  # the port's gradients, one {name: array} a step
    step = StageOptimizer.step

    def recording_step(self, g):
        grads.append({n: np.zeros(tuple(self.params[n].shape), np.float32)
                      if g.get(n) is None else g[n].numpy().copy()
                      for n in self.params})
        return step(self, g)

    monkeypatch.setattr(StageOptimizer, "step", recording_step)
    record = do_train(
        tcfg, port, tdata.make_data_loader(tcfg, 0), None, seed=0,
        test_loader=tdata.make_data_loader(tcfg, 0, is_train=False),
        writer=MetricWriter(tcfg.OUTPUT_DIR, enable_tb=False))
    jparams = jax_run.result()
    pool.shutdown()

    want = _jsonl(tmp_path / "jax" / "metrics.jsonl")
    got = _jsonl(tmp_path / "port" / "metrics.jsonl")
    assert set(got) == set(want)
    assert [want[("train/stage", s)] for s in (1, 2)] == [0, 1]
    assert sum(t.startswith("eval/") for t, _ in want) == 24  # 6 x 2 x 2
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=1e-7,
                                   err_msg=str(key))
    assert [e["stage"] for e in record["epochs"]] == [0, 1]
    assert [len(e["eval"]["loss"]) for e in record["epochs"]] == [2, 2]

    # each step's gradients, JAX's read from its optimizer's first moment:
    # a stage makes one step on fresh moments, mu = (1 - b1) g
    jgrads = [{n: m / (1 - B1) for n, m in _jax_mu(st).items()}
              for st in jopt.states]
    assert len(grads) == len(jgrads) == STEPS
    for g, jg in zip(grads, jgrads):
        assert set(g) <= set(jg)
        for name, w in jg.items():
            if name in g:
                assert w.shape == g[name].shape, (name, "frozen in JAX")
                _close_leaf(g[name], w, name=name)
            else:  # frozen in this stage on both stacks
                assert not w.any(), name

    jsd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    p0 = port0.state_dict()
    held = trained = 0
    for name, p in port.state_dict().items():
        start = p0[name].numpy().astype(np.float64)
        got = p.numpy() - start  # f64: exact
        want = jsd[name].numpy() - start
        sure, atol = _change_atol(name, p0[name].numpy(), grads, jgrads)
        bad = sure & ~(np.abs(got - want) <= atol)
        assert not bad.any(), (name, got[bad][:4], want[bad][:4],
                               atol[bad][:4])
        if name in grads[-1]:
            held += int(sure.sum())
            trained += sure.size
    assert held > 0.9 * trained  # 93 % of the trained elements


def _adam_first(g):
    """The gradient's part of a first AdamW step's update, in f64."""
    g = np.asarray(g, np.float64)
    return g / (np.abs(g) + EPS)


def _change_atol(name, p0, grads, jgrads):
    """Where the final change of parameter `name` is held against JAX's,
    and the tolerance there. Every step is a first step on fresh moments,
    lr (g / (|g| + eps) + wd p): held where, at each step that trains it,
    JAX's gradient g' is further from 0 than twice the two stacks' gap
    (so g has its sign); the two updates then differ by lr |u(g) - u(g')|
    with u(g) = g / (|g| + eps), plus about an ulp of f32 in u, and the
    rounding of p at each step (2 ulp of p). A leaf the loss does not reach has a zero
    gradient on both stacks and moves by the weight decay alone."""
    sure = np.ones(p0.shape, bool)
    atol = 2 * np.spacing(np.abs(p0) + LR * STEPS)
    for g, jg in zip(grads, jgrads):
        if name not in g:
            continue
        sure &= np.abs(jg[name]) > 2 * np.abs(g[name] - jg[name])
        atol = atol + LR * (np.abs(_adam_first(g[name])
                                   - _adam_first(jg[name])) + 2.0 ** -22)
    return sure, atol


class _OptStates:
    """A checkpointer for the JAX loop that keeps the optimizer state it
    is given after each epoch."""

    def __init__(self):
        self.states = []

    def save(self, name, params, opt_state=None, **extra):
        self.states.append(opt_state)


def _detector(decoded):
    """A fixed numpy detector: boxes around the two brightest 16x16
    blocks of a decoded (1, H, W, 3) frame."""
    g = np.asarray(decoded[0], np.float64).mean(-1)
    blocks = g.reshape(4, 16, 4, 16).mean((1, 3)).ravel()
    order = np.argsort(blocks)[::-1][:2]
    ys, xs = np.unravel_index(order, (4, 4))
    return {"boxes": np.stack([xs * 16, ys * 16, xs * 16 + 18,
                               ys * 16 + 20], 1).astype(np.float32),
            "labels": np.array([1, 2], np.int64),
            "scores": blocks[order].astype(np.float32)}


def test_eval_object_detection_matches_jax(models):
    """The rekey / chain protocol (OD_GOP_SIZE 2) over 4 frames, with the
    I-frame stand-in of both packages (the frame tiled over the anchors):
    the same mAP per rate anchor."""
    jmodel, params, port = models
    cfg = t_cfg()
    cfg.DATASET.OD_GOP_SIZE = 2
    rng = np.random.default_rng(1)
    base = rng.random((1, 8, 8, 3))
    frames = [np.kron(np.roll(base, t, axis=2), np.ones((1, 8, 8, 1)))
              .astype(np.float32) for t in range(4)]
    anns = [{"boxes": np.array([[16, 0, 34, 20], [0, 32, 18, 52]],
                               np.float32) + t,
             "labels": np.array([1, 2], np.int64)} for t in range(4)]
    loader = [([f], [a]) for f, a in zip(frames, anns)]
    want = j_eval_object_detection(jmodel, params, cfg, LAMBDAS, loader,
                                   _detector, None)
    got = eval_object_detection(port, cfg, LAMBDAS, loader, _detector, None)
    assert got.shape == (2,) and 0 < float(got.min())
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)


def test_jax_checkpoint_crosses_through_torch_state_dict(tmp_path, models):
    """A JAX .ckpt is refused with the way across named; its parameters
    exported with the JAX package's save_torch_state_dict load into the
    port (strict) and give the forward of the model they came from."""
    _, params, port = models
    jck = JCheckPointer(str(tmp_path))
    jck.save("model_epoch_000", params, None, epoch=1)
    ckpt = str(tmp_path / "model_epoch_000.ckpt")
    fresh = DMC(anchor_num=2, channel_mv=CH[0], channel_N=CH[1],
                channel_M=CH[2], device="cpu")
    with pytest.raises(NotImplementedError, match="save_torch_state_dict"):
        CheckPointer().load(fresh, path=ckpt)
    loaded, _, extra = JCheckPointer().load(params, path=ckpt)
    assert extra == {"epoch": 1}
    pth = str(tmp_path / "exported.pth")
    save_torch_state_dict(loaded, pth)
    fresh.load_state_dict(torch.load(pth, weights_only=True), strict=True)
    assert CheckPointer().load(fresh, path=pth) == {}
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((2, 64, 64, 3), np.float32))
    ref = torch.from_numpy(rng.random((2, 64, 64, 3), np.float32))
    q = port.y_q_scale.detach()
    with torch.no_grad():
        a = fresh.eval()(x, make_dpb(ref, CH[1], CH[2]), q, q, True)
        b = port.eval()(x, make_dpb(ref, CH[1], CH[2]), q, q, True)
    for k in ("bpp", "mse", "me_mse"):
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    torch.testing.assert_close(a["dpb"]["ref_frame"], b["dpb"]["ref_frame"],
                               rtol=0, atol=0)
