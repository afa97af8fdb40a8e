"""PyTorch port, tensor parallelism (parallel/tensor.py's column-parallel
split, the data x model mesh of parallel/mesh.py, trainer_multi --tp)
against the JAX package's GSPMD tensor parallelism
(vcm_ts_tpu/parallel/tensor.py) on the CPU.

Ranks are processes joined by gloo (parallel/spawn.start_ranks, one torch
thread each), started before the parent builds and compiles the JAX side;
the JAX side runs on the virtual CPU devices of tests/conftest.py. Models
are tests/test_tensor_parallel.py's: the damped DMC(anchor_num=2, 16, 16,
24) and IntraNoAR(N=16, anchor_num=2), here the port's seeded damped
inits (utils/weights.init_params, kernel_scale 0.5) carried into flax
trees (flax_params_like).

- The split rule: tp_split against JAX's tp_spec, case by case.
- The DMC's forward split over 2 ranks (tp_forward) against JAX's
  tp_forward on make_tp_mesh(2), on test_tensor_parallel.py's 64x64
  smooth pair: ref_frame rtol 1e-3 / atol 1e-4, bpp rtol 2e-3 / atol 1e-4
  (the JAX test's tolerances), 376 parameters split; IntraNoAR likewise
  (x_hat, bpp), 159 split. The port's count differs from JAX's leaf count:
  a SubpelConv splits by features, so the RGB heads stay whole.
- One single-frame step on 2 x 2 gloo ranks (data x model) against JAX's
  step on make_dp_tp_mesh(2, 2), 4 rows of 64x64 frames, JAX's noise
  draws: the loss rtol 1e-4 / atol 1e-5 on every rank (the JAX test's),
  the gradients (first moments, gathered whole) rtol 1e-2 with 1e-2 of
  each leaf's largest magnitude, and the updated parameters, among them
  optic_flow.moduleBasic.0.conv1.weight, within 1e-7 + 0.05 lr where the
  gradient is above 4e-2 of its leaf's largest and 2.1 lr elsewhere: the
  port's cross-stack step tolerances (tests/test_torch_parallel.py,
  _check_grads and _check_params_across_stacks), looser than the JAX
  test's same-stack 1e-4 / 1e-6 because Adam's first step is a sign and
  the two stacks part where a gradient is within rounding of 0. A whole
  (unsplit) parameter's gradient is bit-equal on the two model ranks.
- The same step with a clip far under the norm: the clipped gradient's
  norm over the whole tree is the clip.
- trainer_multi --tp 2 --device cpu over 2 ranks, one me/single stage of
  2 epochs: the mesh is logged, the epoch records agree on both ranks
  (one frames/s), the checkpoint loads strict into an unsharded DMC and
  moved optic_flow and no module outside the stage's, its moments load
  into the unsharded stage optimizer; a resume from epoch 0's checkpoint
  (the whole tensors re-sliced, the moments restored mid-stage) repeats
  epoch 1 bit for bit; and --fsdp --tp 2 raises.
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
from jax.sharding import PartitionSpec

from tests.test_tensor_parallel import _smooth_pair
from tests.test_torch_parallel import _check_grads, _check_params_across_stacks
from tests.test_torch_train_step import _jax_mu, _named, jax_noise
from tests.test_torch_warp_twopass import (flax_params_like,  # noqa: F401
                                           one_torch_thread)
from tests.torch_parallel_ranks import steps_case, tp_jobs
from vcm_ts_tpu.models.dmc import DMC as JDMC
from vcm_ts_tpu.models.dmc import make_dpb as j_make_dpb
from vcm_ts_tpu.models.intra import IntraNoAR as JIntra
from vcm_ts_tpu.parallel import mesh as jpm
from vcm_ts_tpu.parallel import tensor as jtp
from vcm_ts_tpu.train import train_step as jts
from vcm_ts_tpu.train.optimizer import make_stage_optimizer as j_make_opt
from vcm_ts_tpu.train.stages import StageParams as JStageParams
from vcm_ts_tpu_torch import trainer_multi
from vcm_ts_tpu_torch.codec.png_io import imwrite
from vcm_ts_tpu_torch.models.dmc import DMC
from vcm_ts_tpu_torch.models.intra import IntraNoAR
from vcm_ts_tpu_torch.parallel.spawn import start_ranks
from vcm_ts_tpu_torch.parallel.tensor import tp_split
from vcm_ts_tpu_torch.train.checkpoint import CheckPointer
from vcm_ts_tpu_torch.train.optimizer import (INTER_DIST_MODULES,
                                              make_stage_optimizer)
from vcm_ts_tpu_torch.utils.weights import init_params

CH = (16, 16, 24)
LAMBDAS = [85.0, 170.0]
LR = 1e-4
STAGE = dict(stage=0, p_frames=1, trainable_mode="all",
             forward_method="single", loss_dist_key="mse",
             loss_rate_keys=("bpp_mv_y", "bpp_mv_z", "bpp_y", "bpp_z"),
             lr=LR, perceptual_loss=False)
KEY = jax.random.PRNGKey(0)
DMC_SPLIT, INTRA_SPLIT = 376, 159


@pytest.mark.parametrize("shape,n", [
    ((32, 16, 3, 3), 8), ((32,), 8), ((3, 16, 3, 3), 8), ((4,), 8), ((), 8),
    ((12, 16, 1, 1), 4), ((2, 64), 2), ((6,), 4)])
def test_tp_split_matches_tp_spec(shape, n):
    """torch's output-channel dim 0 against flax's last dim."""
    flax_shape = tuple(shape[1:]) + tuple(shape[:1])
    spec = jtp.tp_spec(flax_shape, n)
    assert tp_split(shape, n) == (spec != PartitionSpec()), (shape, spec)


def _dmc(anchors=2):
    return init_params(DMC(anchor_num=anchors, channel_mv=CH[0],
                           channel_N=CH[1], channel_M=CH[2], device="cpu"),
                       seed=0, kernel_scale=0.5)


def _intra():
    return init_params(IntraNoAR(N=16, anchor_num=2, device="cpu"), seed=0,
                       kernel_scale=0.5)


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _intra_x():
    return np.kron(np.random.default_rng(0).random((1, 4, 4, 3)),
                   np.ones((1, 16, 16, 1))).astype(np.float32)


def _step_rows():
    """4 rows (2 smooth pairs): x and its reference."""
    x1, ref1 = (np.asarray(v) for v in _smooth_pair())
    rng = np.random.default_rng(1)
    base = rng.random((1, 8, 8, 3)).astype(np.float32)
    x2 = np.kron(base, np.ones((1, 8, 8, 1), np.float32))
    ref2 = np.kron(np.roll(base, 1, 1), np.ones((1, 8, 8, 1), np.float32))
    return (np.concatenate([x1, ref1, x2, ref2]),
            np.concatenate([ref1, x1, ref2, x2]))


# p_frames, modules, forward method, dist, rates, lr, epochs, perceptual
ME_SINGLE = ["1", "me", "single", "me", "none", repr(LR), "2", "false"]


def _tree(root):
    """4 sequences of 3 64x64 frames (one iteration on a 1 x 2 mesh: each
    model group takes every row)."""
    rng = np.random.default_rng(3)
    for s in range(4):
        d = root / "train" / "g" / f"seq{s}" / "raw"
        os.makedirs(d)
        base = rng.random((9, 9, 3))
        for t in range(3):
            img = np.kron(np.roll(base, t, axis=1), np.ones((8, 8, 1)))
            imwrite(str(d / f"{t:05d}.png"),
                    (img[:64, :64] * 255).astype(np.uint8))


def _yaml(root, out, init_path):
    """The YAML of one me/single stage of 2 epochs over _tree(root),
    starting from init_path, written to out."""
    cfg = root / f"{out.name}.yaml"
    cfg.write_text(f"""MODEL:
  PRETRAINED_WEIGHTS: '{init_path}'
  CHANNELS: [{CH[0]}, {CH[1]}, {CH[2]}]
DATASET:
  TYPE: SequenceDataset
  TRAIN_ROOT_DIRS: ['{root / "train"}']
  TRAIN_SUBDIR_LISTS: ['']
  SEQUENCE_LENGTH: 3
INPUT:
  IMAGE_SIZE: [64, 64]
SOLVER:
  LAMBDAS: [85.0, 170.0, 380.0, 840.0]
  STAGES:
    - {json.dumps(ME_SINGLE)}
OUTPUT_DIR: '{out}'
""")
    return str(cfg)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns (2 ranks: the forwards and trainer_multi --tp 2; 4
    ranks: the 2 x 2 step) started first; meanwhile, here, the JAX side."""
    root = tmp_path_factory.mktemp("tp")
    dmc, intra = _dmc(), _intra()
    x, ref = (np.asarray(v) for v in _smooth_pair())
    ix = _intra_x()
    fwd_spec = {"dmc": {"channels": CH, "anchors": 2, "state": _state(dmc)},
                "intra": {"N": 16, "anchors": 2, "state": _state(intra)},
                "x": x, "ref": ref, "ix": ix}
    init = _dmc(anchors=4)
    CheckPointer(str(root / "init")).save("init", init)
    _tree(root)
    out_dir, resume_dir = root / "run", root / "resume"
    jobs = [["--device", "cpu", "--tp", "2", "--config-file", cfg]
            for cfg in (_yaml(root, out_dir, root / "init" / "init.pt"),
                        _yaml(root, resume_dir,
                              out_dir / "model_epoch_000.pt"))]
    xs, refs = _step_rows()
    noise = [v.numpy() for v in jax_noise(KEY, dmc.noise_shapes(4, 64, 64))]
    step_spec = dict(channels=CH, anchors=2, lambdas=LAMBDAS, lr=LR,
                     clip=0.0, accum=1, kind="single", stage=STAGE, x=xs,
                     ref=refs, noise=noise, state=_state(dmc), tp=2)
    with start_ranks(tp_jobs, 2, fwd_spec, jobs) as two, \
            start_ranks(steps_case, 4,
                        [step_spec, dict(step_spec, clip=1e-3)]) as four, \
            ThreadPoolExecutor(3) as pool:
        # XLA compiles outside the interpreter lock: the three overlap
        jobs = {"dmc": pool.submit(_jax_dmc_forward, dmc, x, ref),
                "intra": pool.submit(_jax_intra_forward, intra, ix),
                "step": pool.submit(_jax_dp_tp_step, dmc, xs, refs)}
        jax_side = {k: f.result() for k, f in jobs.items()}
        res2, res4 = two.join(), four.join()
    return {"jax": jax_side, "two": [r["result"] for r in res2],
            "four": [r["result"][0] for r in res4],
            "four_clip": [r["result"][1] for r in res4], "init": _state(init),
            "step_init": step_spec["state"], "out_dir": out_dir,
            "resume_dir": resume_dir}


def _jax_dmc_forward(port, x, ref):
    model = JDMC(anchor_num=2, channel_mv=CH[0], channel_N=CH[1],
                 channel_M=CH[2])
    x0 = jnp.zeros((1, 64, 64, 3))
    params = flax_params_like(
        lambda: model.init(jax.random.PRNGKey(0), x0,
                           j_make_dpb(x0, CH[1], CH[2]), 1.0, 1.0,
                           method="init_all"), port)
    mesh = jtp.make_tp_mesh(2)
    p = jtp.shard_params_tp(params, mesh)
    jtp.assert_params_sharded(p, mesh)
    dpb = j_make_dpb(jnp.asarray(ref), CH[1], CH[2])
    out = jtp.tp_forward(model, mesh, is_first_p=True)(
        p, jtp.replicate(jnp.asarray(x), mesh), jtp.replicate(dpb, mesh),
        jnp.ones(()), jnp.ones(()))
    return {"ref_frame": np.asarray(out["dpb"]["ref_frame"]),
            "bpp": np.asarray(out["bpp"])}


def _jax_intra_forward(port, ix):
    model = JIntra(N=16, anchor_num=2)
    q = jnp.ones((1, 1, 1, 1))
    params = flax_params_like(
        lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(ix), q), port)
    mesh = jtp.make_tp_mesh(2)
    p = jtp.shard_params_tp(params, mesh)
    jtp.assert_params_sharded(p, mesh)
    out = jax.jit(model.apply)(p, jtp.replicate(jnp.asarray(ix), mesh),
                               jtp.replicate(q, mesh))
    return {"x_hat": np.asarray(out["x_hat"]), "bpp": np.asarray(out["bpp"])}


def _jax_dp_tp_step(port, xs, refs):
    """The JAX single-frame step on make_dp_tp_mesh(2, 2): batch over
    "data", weights and Adam moments over "model"."""
    model = JDMC(anchor_num=2, channel_mv=CH[0], channel_N=CH[1],
                 channel_M=CH[2])
    x0 = jnp.zeros((1, 64, 64, 3))
    params = flax_params_like(
        lambda: model.init(jax.random.PRNGKey(0), x0,
                           j_make_dpb(x0, CH[1], CH[2]), 1.0, 1.0,
                           method="init_all"), port)
    mesh = jtp.make_dp_tp_mesh(2, 2)
    tx, opt_state = j_make_opt(params, "all", LR)
    step = jts.make_single_frame_step(model, tx, JStageParams(**STAGE),
                                      lambdas=LAMBDAS, dist_lambda=1.0,
                                      pl_lambda=0.0)
    p = jtp.shard_params_tp(params, mesh)
    o = jtp.shard_params_tp(opt_state, mesh)
    x = jpm.shard_batch(jnp.asarray(xs), mesh)
    ref = jpm.shard_batch(jnp.asarray(refs), mesh)
    new_p, new_o, aux, _ = step(p, o, x, x, j_make_dpb(ref, CH[1], CH[2]),
                                KEY, True)
    return {"loss": np.asarray(aux.loss), "mu": _jax_mu(new_o),
            "params": _named(new_p)}


@pytest.mark.parametrize("name", ["dmc", "intra"])
def test_tp_forward_matches_jax_tp_forward(runs, name):
    """Each of the 2 ranks gives the JAX 2-device TP forward's outputs,
    with the weights really split (the port's count of split
    parameters) and about half of them on each rank."""
    want = runs["jax"][name]
    for r in runs["two"]:
        got = r["forward"][name]
        if name == "dmc":
            np.testing.assert_allclose(got["ref_frame"], want["ref_frame"],
                                       rtol=1e-3, atol=1e-4)
        else:
            np.testing.assert_allclose(got["x_hat"], want["x_hat"],
                                       rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(got["bpp"], want["bpp"], rtol=2e-3,
                                   atol=1e-4)
        assert got["n_split"] == {"dmc": DMC_SPLIT,
                                  "intra": INTRA_SPLIT}[name]
        assert 0.5 < got["rank_bytes"] / got["whole_bytes"] < 0.6
    a, b = (r["forward"][name] for r in runs["two"])
    key = "ref_frame" if name == "dmc" else "x_hat"
    assert np.array_equal(a[key], b[key])  # one whole output on both ranks


def test_dp_tp_step_matches_jax_dp_tp_step(runs):
    want = runs["jax"]["step"]
    for r in runs["four"]:
        assert r["n_split"] == DMC_SPLIT
        assert r["counts"]["reduce_gradients"] == 1
        np.testing.assert_allclose(r["aux"]["loss"], want["loss"], rtol=1e-4,
                                   atol=1e-5)
    got = runs["four"][0]
    _check_grads(got["opt"]["mu"], want["mu"])
    _check_params_across_stacks(got["params"], want["params"], want["mu"])
    k = "optic_flow.moduleBasic.0.conv1.weight"
    assert np.abs(got["params"][k] - runs["step_init"][k].numpy()).max() > 0
    # every rank ends with the same whole parameters
    for r in runs["four"][1:]:
        for name, v in got["params"].items():
            assert np.array_equal(r["params"][name], v), name


def test_whole_parameter_gradients_equal_on_model_ranks(runs):
    """Ranks 0 and 1 form one model group (data index 0): the gradients
    of the parameters that stay whole are bit-equal there as each rank
    computes them, before the broadcast from model rank 0 that keeps them
    equal on a card, whose sums may take another order on each rank."""
    a, b = (r["whole_grads"] for r in runs["four"][:2])
    assert set(a) == set(b) and len(a) > 0
    for name in a:
        assert np.array_equal(a[name], b[name]), name
    shares = runs["four"][0]["share"]
    assert sum(v == 0.5 for v in shares.values()) == DMC_SPLIT


def test_trainer_multi_tp_trains_and_checkpoints_whole(runs):
    recs = [r["trainer"][0] for r in runs["two"]]
    for rec in recs:
        assert [e["stage"] for e in rec["epochs"]] == [0, 0]
        assert [e["frames"] for e in rec["epochs"]] == [8, 8]
    # one barrier-started clock, the slowest rank's seconds on both
    for a, b in zip(*(rec["epochs"] for rec in recs)):
        assert a["train_s"] == b["train_s"]
    assert recs[0]["iterations"] == recs[1]["iterations"]
    log = (runs["out_dir"] / "logs.txt").read_text()
    assert "tensor parallelism: mesh {'data': 1, 'model': 2}" in log
    model = DMC(anchor_num=4, channel_mv=CH[0], channel_N=CH[1],
                channel_M=CH[2], device="cpu")
    path = str(runs["out_dir"] / "model_epoch_000.pt")
    assert CheckPointer().load(model, path=path) == {"epoch": 1}
    assert (runs["out_dir"] / "model_epoch_001.pt").exists()
    moved = {k.split(".")[0] for k, v in model.state_dict().items()
             if not torch.equal(v, runs["init"][k])}
    assert "optic_flow" in moved and moved <= INTER_DIST_MODULES
    opt = make_stage_optimizer(model, "inter_dist", LR)
    opt.load_state_dict(CheckPointer().load_opt_state(path=path))
    assert float(opt.mu["optic_flow.moduleBasic.0.conv1.weight"].abs()
                 .max()) > 0


def test_trainer_multi_tp_resume_reslices_and_repeats_the_run(runs):
    """trainer_multi --tp 2 resumed from epoch 0's whole checkpoint
    (mid-stage: the moments are restored, each rank taking its slices)
    repeats epoch 1 of the uninterrupted run bit for bit, on both
    ranks."""
    for r in runs["two"]:
        rec = r["trainer"][1]
        assert [e["epoch"] for e in rec["epochs"]] == [1]
        want = [it for it in r["trainer"][0]["iterations"]
                if it["epoch"] == 1]
        assert rec["iterations"] == want
    a, b = (torch.load(d / "model_epoch_001.pt", weights_only=True)
            for d in (runs["resume_dir"], runs["out_dir"]))
    for name in b["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name
    for part in ("mu", "nu"):
        for name, v in b["opt_state"][part].items():
            assert torch.equal(a["opt_state"][part][name], v), (part, name)


def test_dp_tp_clip_uses_the_global_norm(runs):
    """A clip far under the gradients' norm binds on the norm over the
    whole tree (the slices' squares summed over the model group, whole
    parameters once): after one step mu = (1 - b1) g of the clipped g,
    whose norm is the clip, on every rank."""
    for r in runs["four_clip"]:
        norm = np.sqrt(sum(float(np.sum((v / 0.1) ** 2))
                           for v in r["opt"]["mu"].values()))
        assert norm == pytest.approx(1e-3, rel=1e-3)


def test_mesh_and_cli_refusals(runs):
    for r in runs["two"]:
        assert "must divide the world size 2" in r["mesh_error"]
    with pytest.raises(SystemExit, match="mutually exclusive"):
        trainer_multi.main(["--device", "cpu", "--tp", "2", "--fsdp"])
    with pytest.raises(SystemExit, match="torchrun"):
        trainer_multi.main(["--device", "cpu", "--tp", "2"])
