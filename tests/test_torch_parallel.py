"""PyTorch port, multi-process training and serving (parallel/,
trainer_multi, the harness's rank split, fleet serving) on the CPU: ranks
are processes joined by gloo through a `file://` rendezvous
(vcm_ts_tpu_torch/parallel/spawn.run_ranks), one torch thread each.

A DMC at 16/16/24 with 4 anchors on the port's seeded damped init, 64x64
frames made with numpy, 8 global rows (2 ranks of 4).

- The data-parallel step and the FSDP step against the JAX package's DP
  step on a 2-device virtual mesh (pm.make_mesh(2), replicate,
  shard_batch), the same 8 rows, weights (state_dict_from_flax's inverse,
  flax_params_like) and noise (JAX's draws of the global batch, each rank
  taking its rows): the loss and FrameAux rtol 1e-4 on both ranks, the
  gradients (the first moment after one step) as
  tests/test_torch_train_step.py holds them across the stacks (rtol 1e-2,
  atol 1e-2 of each leaf's largest magnitude), and each updated parameter
  within 1e-7 + 0.05 lr where its gradient is above 4e-2 of its leaf's
  largest magnitude, 2.1 lr elsewhere (Adam's first step is a sign; where
  |g| is near eps two stacks' sums part, as chip_smoke.py's phase 8 holds
  the card against the CPU).
- The same steps against the port's one-process step on the 8 global rows
  (the same stack: only the order of the gradient sums differs): every
  parameter within atol 1e-7 + 1e-3 lr, the moments rtol 1e-6 with an atol
  of 1e-4 of each leaf's largest magnitude (a leaf that is a sum of
  cancelling terms keeps its absolute rounding, measured up to 3.5e-5 of
  its scale).
- A cascade step with GRAD_ACCUM_STEPS 2 and a clip that binds, 2 ranks
  against one process: one reduce_gradients call per step, the clip on
  the global norm.
- trainer_multi over 2 ranks on a tree of 64x64 tiles (a single and a
  cascade stage, one iteration each) against one-process do_train on the
  same global rows at lr x sqrt(2), its checkpoints, a 2-rank resume, and
  --fsdp.
- The harness: fleet_mesh_size against the JAX harness's, test_video's
  2-rank split against one process, fleet batches against unsharded
  ones; fleet and spatial mode refuse each other.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import _jax_mu, _named, jax_noise
from tests.test_torch_warp_twopass import (flax_params_like,  # noqa: F401
                                           one_torch_thread)
from tests.torch_parallel_ranks import (step_case, steps_case, trainer_case,
                                        video_case)
from vcm_ts_tpu.models.dmc import DMC as JDMC
from vcm_ts_tpu.models.dmc import make_dpb as j_make_dpb
from vcm_ts_tpu.parallel import mesh as jpm
from vcm_ts_tpu.train import train_step as jts
from vcm_ts_tpu.train.config import default_training_cfg as j_default_cfg
from vcm_ts_tpu.data import make_data_loader as j_make_data_loader
from vcm_ts_tpu.train.optimizer import make_stage_optimizer as j_make_opt
from vcm_ts_tpu.train.stages import StageParams as JStageParams
from vcm_ts_tpu_torch import data as tdata
from vcm_ts_tpu_torch import test_video as ttv
from vcm_ts_tpu_torch import trainer_multi
from vcm_ts_tpu_torch.codec.engine import IntraCodec, VideoCodec
from vcm_ts_tpu_torch.codec.png_io import imwrite
from vcm_ts_tpu_torch.models.dmc import DMC, make_dpb
from vcm_ts_tpu_torch.parallel import mesh as pm
from vcm_ts_tpu_torch.parallel.spawn import start_ranks
from vcm_ts_tpu_torch.train.checkpoint import CheckPointer
from vcm_ts_tpu_torch.train.tensorboard import MetricWriter
from vcm_ts_tpu_torch.train.train_loop import do_train
from vcm_ts_tpu_torch.utils.config import default_training_cfg
from vcm_ts_tpu_torch.utils.weights import init_params, make_dmc, make_intra

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CH = (16, 16, 24)
LAMBDAS = [85.0, 170.0, 380.0, 840.0]
ALL_RATES = ("bpp_mv_y", "bpp_mv_z", "bpp_y", "bpp_z")
LR = 1e-4
N = 8  # global rows: 2 ranks of 4
STAGE = dict(stage=0, p_frames=1, trainable_mode="all",
             forward_method="single", loss_dist_key="mse",
             loss_rate_keys=ALL_RATES, lr=LR, perceptual_loss=False)
KEY = jax.random.PRNGKey(21)


def _frames(t, seed):
    """(t, N, 64, 64, 3) smooth frames whose 8x8 blocks move."""
    rng = np.random.default_rng(seed)
    base = rng.random((N, 8, 8, 3)).astype(np.float32)
    return np.stack([np.kron(np.roll(base, k, axis=2),
                             np.ones((1, 8, 8, 1), np.float32))
                     for k in range(t)])


@pytest.fixture(scope="module")
def port0():
    return init_params(DMC(anchor_num=4, channel_mv=CH[0], channel_N=CH[1],
                           channel_M=CH[2], device="cpu"), seed=0,
                       kernel_scale=0.5)


def _spec(port0, **kw):
    spec = dict(channels=CH, anchors=4, lambdas=LAMBDAS, lr=LR, clip=0.0,
                accum=1, state={k: v.clone() for k, v in
                                port0.state_dict().items()})
    spec.update(kw)
    return spec


@pytest.fixture(scope="module")
def single_spec(port0):
    seq = _frames(2, seed=0)
    noise = [np.asarray(v) for v in jax_noise(KEY, port0.noise_shapes(
        N, 64, 64))]
    return _spec(port0, kind="single", stage=STAGE, x=seq[1], ref=seq[0],
                 noise=noise)


@pytest.fixture(scope="module")
def cascade_spec(port0):
    """p_frames 2, GRAD_ACCUM_STEPS 2, a clip far under the norm."""
    seq = _frames(3, seed=1)
    rng = np.random.default_rng(2)
    shapes = port0.noise_shapes(N // 2, 64, 64)
    noise = [[[rng.uniform(-0.5, 0.5, s).astype(np.float32)
               for s in shapes] for _ in range(2)] for _ in range(2)]
    return _spec(port0, kind="cascade", accum=2, clip=1e-3,
                 stage=dict(STAGE, p_frames=2, forward_method="cascade"),
                 xs=seq[1:], ref=seq[0], noise=noise)


@pytest.fixture(scope="module")
def steps(port0, single_spec, cascade_spec):
    """Both ranks' results of the DP step, the FSDP step and the cascade
    step with accumulation (one spawn), and meanwhile, here, the JAX DP
    step and the port's one-process steps on the global rows."""
    mp = dict(single_spec, compute_dtype="bf16")
    specs = [single_spec, dict(single_spec, fsdp=True), cascade_spec,
             dict(mp, fsdp=True), dict(cascade_spec, fsdp=True)]
    with start_ranks(steps_case, 2, specs) as started:
        out = {"jax": _jax_dp(port0, single_spec),
               "one": {"single": step_case(single_spec),
                       "cascade": step_case(cascade_spec),
                       "bf16": step_case(mp)}}
        res = started.join()
    out.update({name: [r["result"][i] for r in res] for i, name in
                enumerate(("dp", "fsdp", "cascade", "fsdp_bf16",
                           "cascade_fsdp"))})
    return out


def _jax_dp(port0, single_spec):
    """The JAX package's single-frame step on a 2-device "data" mesh."""
    jmodel = JDMC(anchor_num=4, channel_mv=CH[0], channel_N=CH[1],
                  channel_M=CH[2])
    x0 = jnp.zeros((1, 64, 64, 3))
    params = flax_params_like(
        lambda: jmodel.init(jax.random.PRNGKey(0), x0,
                            j_make_dpb(x0, CH[1], CH[2]), 1.0, 1.0,
                            method="init_all"), port0)
    mesh = jpm.make_mesh(2)
    tx, opt_state = j_make_opt(params, "all", LR)
    step = jts.make_single_frame_step(jmodel, tx, JStageParams(**STAGE),
                                      lambdas=LAMBDAS, dist_lambda=1.0,
                                      pl_lambda=0.0)
    x = jpm.shard_batch(jnp.asarray(single_spec["x"]), mesh)
    ref = jpm.shard_batch(jnp.asarray(single_spec["ref"]), mesh)
    new_p, new_o, aux, _ = step(jpm.replicate(params, mesh),
                                jpm.replicate(opt_state, mesh), x, x,
                                j_make_dpb(ref, CH[1], CH[2]), KEY, True)
    return {"aux": {f: np.asarray(v) for f, v in aux._asdict().items()},
            "mu": _jax_mu(new_o), "params": _named(new_p)}


def _check_aux(got, want):
    for f in ("loss", "rate", "dist", "p_dist", "bpp", "psnr", "me_psnr"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-4, atol=1e-6,
                                   err_msg=f)


def _check_params_across_stacks(got, want, mu):
    for name, w in want.items():
        g = np.abs(mu[name]).max()
        firm = np.abs(mu[name]) > 4e-2 * g
        tol = np.where(firm, 1e-7 + 0.05 * LR, 2.1 * LR)
        d = np.abs(got[name] - w)
        assert (d <= tol).all(), (name, float(d.max()))


def _check_same_stack(got, want):
    for name, w in want["params"].items():
        np.testing.assert_allclose(got["params"][name], w, rtol=0,
                                   atol=1e-7 + 1e-3 * LR, err_msg=name)
    for part in ("mu", "nu"):
        for name, w in want["opt"][part].items():
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(got["opt"][part][name], w, rtol=1e-6,
                                       atol=1e-4 * scale,
                                       err_msg=f"{part} {name}")
    assert got["opt"]["count"] == want["opt"]["count"]


def _check_grads(mu, want):
    assert set(mu) == set(want)
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(mu[name], w, rtol=1e-2,
                                   atol=1e-2 * scale, err_msg=name)


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_step_matches_jax_dp_on_two_devices(steps, mode):
    """Loss and FrameAux on both ranks, gradients and updated parameters
    against the JAX package's 2-device DP step."""
    jax_dp = steps["jax"]
    for r in steps[mode]:
        _check_aux(r["aux"], jax_dp["aux"])
    got = steps[mode][0]
    _check_grads(got["opt"]["mu"], jax_dp["mu"])
    _check_params_across_stacks(got["params"], jax_dp["params"],
                                jax_dp["mu"])


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_step_matches_one_process_on_global_rows(steps, mode):
    """Every rank ends the step with the one-process step's parameters
    and moments; one gradient reduction."""
    for r in steps[mode]:
        _check_same_stack(r, steps["one"]["single"])
        _check_aux(r["aux"], steps["one"]["single"]["aux"])
        assert r["counts"]["reduce_gradients"] == 1


def test_fsdp_shards_weights_and_moments(steps):
    """Each rank holds half of every parameter whose first dimension
    divides by 2, but the q-scale tables the step reads outside the
    forward, which stay whole."""
    shares = [r["share"] for r in steps["fsdp"]]
    model = DMC(anchor_num=4, channel_mv=CH[0], channel_N=CH[1],
                channel_M=CH[2], device="cpu")
    halves = 0
    for name, p in model.named_parameters():
        got = [s[name] for s in shares]
        if name in ("mv_y_q_scale", "y_q_scale"):
            assert got == [1.0, 1.0], name
        elif p.shape[0] % 2 == 0:
            assert got == [0.5, 0.5], (name, got)
            halves += 1
        else:
            assert abs(sum(got) - 1.0) < 1e-9, (name, got)
    assert halves > 0.9 * sum(1 for _ in model.parameters())
    assert all(v == 1.0 for v in steps["dp"][0]["share"].values())


@pytest.mark.parametrize("mode", ["cascade", "cascade_fsdp"])
def test_cascade_accumulation_two_ranks_match_one_process(steps, mode):
    """GRAD_ACCUM_STEPS 2 with p_frames 2, DP and FSDP: one
    reduce_gradients call per step (of the summed groups; under FSDP the
    groups before the last skip fully_shard's reduce-scatter), the clip on
    the global norm, the one-process step's FrameAux, parameters and
    moments on both ranks."""
    want = steps["one"]["cascade"]
    for r in steps[mode]:
        assert r["counts"]["reduce_gradients"] == 1
        _check_aux(r["aux"], want["aux"])
        _check_same_stack(r, want)
    # the clip binds: after one step mu = (1 - b1) g of the clipped g
    norm = np.sqrt(sum(float(np.sum((v / 0.1) ** 2))
                       for v in want["opt"]["mu"].values()))
    assert norm == pytest.approx(1e-3, rel=1e-3)


def test_fsdp_bf16_compute_matches_one_process(steps):
    """SOLVER.MIXED_PRECISION under FSDP (fully_shard gathers the f32
    shards as bf16, the bit estimators' groups as f32) against the
    one-process bf16 step (cast_for_compute): the same FrameAux (rtol
    1e-4), gradients within 5e-2 of each leaf's scale (bf16 products
    summed in another order), f32 masters and moments."""
    want = steps["one"]["bf16"]
    for r in steps["fsdp_bf16"]:
        _check_aux(r["aux"], want["aux"])
        for name, w in want["opt"]["mu"].items():
            scale = max(float(np.abs(w).max()), 1e-30)
            assert np.abs(r["opt"]["mu"][name] - w).max() <= 5e-2 * scale
        assert all(v.dtype == np.float32 for v in r["params"].values())


class _Rank1Of3:
    """A stand-in for a 3-rank DeviceMesh, seen from rank 1."""

    def get_local_rank(self):
        return 1

    def size(self):
        return 3


def test_global_batch_splits_rows_in_rank_order():
    x = torch.arange(36.0).reshape(2, 6, 3)
    rows = pm.global_batch({"x": x, "a": [x.numpy()]}, _Rank1Of3(),
                           batch_dim=1)
    assert torch.equal(rows["x"], x[:, 2:4])
    np.testing.assert_array_equal(rows["a"][0], x.numpy()[:, 2:4])
    with pytest.raises(ValueError, match="do not split"):
        pm.global_batch(x, _Rank1Of3(), batch_dim=0)
    # one process: every row, no collective
    assert torch.equal(pm.global_batch(x, batch_dim=1), x)
    assert pm.reduce_gradients({"a": x, "b": None}) == {"a": x, "b": None}
    assert pm.get_world_size() == 1 and pm.is_main_process()
    pm.initialize_distributed(device="cpu")  # no torchrun environment
    assert not torch.distributed.is_initialized()


# ----------------------------------------------------------- trainer_multi
# p_frames, modules, forward method, dist, rates, lr, epochs, perceptual
SINGLE = ["1", "me", "single", "me", "none", "{lr}", "1", "false"]
CASCADE = ["2", "all", "cascade", "rec", "all", "{lr}", "1", "false"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """8 sequences of 3 64x64 frames (one iteration an epoch on 2 ranks)
    and the damped DMC as a port checkpoint, init/init.pt."""
    root = tmp_path_factory.mktemp("multi")
    model = init_params(DMC(anchor_num=4, channel_mv=CH[0], channel_N=CH[1],
                            channel_M=CH[2], device="cpu"), seed=0,
                        kernel_scale=0.5)
    CheckPointer(str(root / "init")).save("init", model)
    rng = np.random.default_rng(3)
    for s in range(8):
        d = root / "train" / "g" / f"seq{s}" / "raw"
        os.makedirs(d)
        base = rng.random((9, 9, 3))
        for t in range(3):
            img = np.kron(np.roll(base, t, axis=1), np.ones((8, 8, 1)))
            imwrite(str(d / f"{t:05d}.png"),
                    (img[:64, :64] * 255).astype(np.uint8))
    return root


def _yaml(tree, out, lr=LR, init=None):
    stages = [[f.format(lr=repr(float(lr))) for f in s]
              for s in (SINGLE, CASCADE)]
    lines = "\n".join(f"    - {json.dumps(s)}" for s in stages)
    path = os.path.join(str(out) + ".yaml")
    with open(path, "w") as f:
        f.write(f"""MODEL:
  PRETRAINED_WEIGHTS: '{init or ""}'
  CHANNELS: [{CH[0]}, {CH[1]}, {CH[2]}]
DATASET:
  TYPE: SequenceDataset
  TRAIN_ROOT_DIRS: ['{tree / "train"}']
  TRAIN_SUBDIR_LISTS: ['']
  SEQUENCE_LENGTH: 3
INPUT:
  IMAGE_SIZE: [64, 64]
SOLVER:
  LAMBDAS: {LAMBDAS}
  STAGES:
{lines}
OUTPUT_DIR: '{out}'
""")
    return path


class _GlobalRows:
    """Both ranks' loader batches of an epoch, concatenated in rank order:
    the global batch of a 2-rank run, for one process."""

    def __init__(self, cfg):
        self.loaders = [tdata.make_data_loader(cfg, 0, rank=r, world_size=2)
                        for r in range(2)]

    def set_epoch(self, epoch):
        for loader in self.loaders:
            loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loaders[0])

    def __iter__(self):
        for parts in zip(*self.loaders):
            yield tuple(np.concatenate(p) for p in zip(*parts))


@pytest.fixture(scope="module")
def multi(tree, tmp_path_factory):
    """trainer_multi over 2 ranks: DP, a DP resume from epoch 0's
    checkpoint, --fsdp (one spawn); and one process on the global rows
    at lr x sqrt(2)."""
    base = tmp_path_factory.mktemp("runs")
    dp, fsdp = base / "dp", base / "fsdp"
    resume = base / "resume"
    init = str(tree / "init" / "init.pt")
    argv = ["--device", "cpu", "--config-file"]
    jobs = [argv + [_yaml(tree, dp, init=init)],
            argv + [_yaml(tree, resume, init=str(
                dp / "model_epoch_000.pt"))],
            argv[:2] + ["--fsdp"] + argv[2:] + [_yaml(tree, fsdp,
                                                      init=init)]]
    with start_ranks(trainer_case, 2, jobs) as started:
        one_dir = base / "one"
        cfg = default_training_cfg()
        cfg.merge_from_file(_yaml(tree, one_dir, lr=LR * np.sqrt(2)))
        cfg.freeze()
        model = DMC(anchor_num=4, channel_mv=CH[0], channel_N=CH[1],
                    channel_M=CH[2], device="cpu")
        CheckPointer().load(model, path=init)
        rec = do_train(cfg, model, _GlobalRows(cfg),
                       CheckPointer(str(one_dir)), seed=0,
                       writer=MetricWriter(str(one_dir), enable_tb=False))
        res = started.join()
    return {"dirs": {"dp": dp, "fsdp": fsdp, "resume": resume},
            "ranks": [r["result"] for r in res], "one": rec,
            "one_params": {k: v.detach().clone()
                           for k, v in model.state_dict().items()}}


def _ckpt(path):
    return torch.load(path, weights_only=True)


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_trainer_multi_matches_one_process(multi, mode):
    i = {"dp": 0, "fsdp": 2}[mode]
    for rank in range(2):
        rec = multi["ranks"][rank][i]
        assert [e["stage"] for e in rec["epochs"]] == [0, 1]
        assert [e["frames"] for e in rec["epochs"]] == [16, 16]
        for got, want in zip(rec["iterations"], multi["one"]["iterations"]):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    # 3 Adam steps at lr x sqrt(2): an element whose gradient is within
    # rounding of 0 (|g| near eps, where the two runs' sums part) may step
    # by up to 2 lr another way; at most 1e-3 of all elements do
    lr = LR * np.sqrt(2)
    final = _ckpt(multi["dirs"][mode] / "model_epoch_001.pt")
    off = total = 0
    for name, want in multi["one_params"].items():
        d = np.abs(final["params"][name].numpy() - want.numpy())
        assert d.max() <= 3 * 2.1 * lr, (name, d.max())
        off += int(np.sum(d > 1e-6))
        total += d.size
    assert off <= 1e-3 * total, (off, total)


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_trainer_multi_rank0_writes_and_checkpoints_load_strict(multi,
                                                                mode):
    """Only rank 0 writes (one cfg.yaml, one log, one metrics file, one
    checkpoint an epoch); each checkpoint loads strict into the
    one-process trainer's DMC, its optimizer state into a stage optimizer
    of the one-process model."""
    from vcm_ts_tpu_torch.train.optimizer import make_stage_optimizer

    d = multi["dirs"][mode]
    names = sorted(os.listdir(d))
    # the logger's file goes to the first run's directory of a process
    logs = ["logs.txt"] if mode == "dp" else []
    assert names == sorted(["cfg.yaml", "last_checkpoint.txt",
                            "metrics.jsonl", "model_epoch_000.pt",
                            "model_epoch_001.pt"] + logs), names
    if logs:
        text = (d / "logs.txt").read_text()
        assert "rank=0" in text and "rank=1" not in text
    for e, mode_name in ((0, "inter_dist"), (1, "all")):
        model = DMC(anchor_num=4, channel_mv=CH[0], channel_N=CH[1],
                    channel_M=CH[2], device="cpu")
        path = str(d / f"model_epoch_{e:03d}.pt")
        assert CheckPointer().load(model, path=path) == {"epoch": e + 1}
        opt = make_stage_optimizer(model, mode_name, LR)
        opt.load_state_dict(CheckPointer().load_opt_state(path=path))


def test_trainer_multi_resume_repeats_uninterrupted_run(multi):
    """2 ranks resumed from epoch 0's checkpoint repeat epoch 1."""
    rec = multi["ranks"][0][1]
    assert [e["epoch"] for e in rec["epochs"]] == [1]
    want = [it for it in multi["ranks"][0][0]["iterations"]
            if it["epoch"] == 1]
    assert rec["iterations"] == want
    a = _ckpt(multi["dirs"]["resume"] / "model_epoch_001.pt")["params"]
    b = _ckpt(multi["dirs"]["dp"] / "model_epoch_001.pt")["params"]
    for name in b:
        assert torch.equal(a[name], b[name]), name


def test_trainer_multi_refuses_tp_and_fsdp_with_tp():
    """--tp needs a process group (no torchrun here); --fsdp and --tp
    exclude each other (tests/test_torch_tensor_parallel.py trains with
    --tp on ranks)."""
    with pytest.raises(SystemExit, match="torchrun"):
        trainer_multi.main(["--device", "cpu", "--tp", "2"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        trainer_multi.main(["--device", "cpu", "--tp", "2", "--fsdp"])


def test_data_rank_shard_matches_jax(tree):
    """Each rank's epoch batches equal the JAX package's for the same
    (seed, epoch, rank, world size)."""
    cfgs = []
    for make in (default_training_cfg, j_default_cfg):
        cfg = make()
        cfg.DATASET.TYPE = "SequenceDataset"
        cfg.DATASET.TRAIN_ROOT_DIRS = [str(tree / "train")]
        cfg.DATASET.TRAIN_SUBDIR_LISTS = [""]
        cfg.DATASET.SEQUENCE_LENGTH = 3
        cfg.INPUT.IMAGE_SIZE = [64, 64]
        cfg.SOLVER.LAMBDAS = [85.0, 170.0]
        cfgs.append(cfg)
    for rank in range(2):
        loaders = [tdata.make_data_loader(cfgs[0], 5, rank=rank,
                                          world_size=2),
                   j_make_data_loader(cfgs[1], 5, rank=rank, world_size=2)]
        for epoch in range(2):
            for loader in loaders:
                loader.set_epoch(epoch)
            got, want = (list(loader) for loader in loaders)
            assert len(got) == len(want) == 2
            for (gi, gt), (wi, wt) in zip(got, want):
                np.testing.assert_array_equal(gi, np.asarray(wi))
                np.testing.assert_array_equal(gt, np.asarray(wt))


# ----------------------------------------------------- harness and fleet
def _root_test_video():
    spec = importlib.util.spec_from_file_location(
        "root_test_video", os.path.join(REPO, "test_video.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tasks(groups):
    return [{"ds_name": ds, "video_path": seq}
            for ds, seq, n in groups for _ in range(n)]


@pytest.mark.parametrize("groups,n_dev", [
    ([("a", "s", 4)], 8), ([("a", "s", 4)], 3), ([("a", "s", 2)], 4),
    ([("a", "s", 4), ("a", "t", 6)], 8), ([("a", "s", 3), ("b", "s", 3)], 6),
    ([], 4), ([("a", "s", 1)], 1)])
def test_fleet_mesh_size_matches_jax(groups, n_dev):
    jtv = _root_test_video()
    tasks = _tasks(groups)
    assert ttv.fleet_mesh_size(tasks, n_dev) == jtv.fleet_mesh_size(tasks,
                                                                     n_dev)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """test_video over 1 sequence x 2 rate points (64x64, 3 frames, gop 2,
    real streams), one process and 2 ranks."""
    root = tmp_path_factory.mktemp("harness")
    seq = root / "data" / "seq0"
    os.makedirs(seq)
    rng = np.random.default_rng(4)
    base = rng.random((9, 9, 3))
    for t in range(3):
        img = np.kron(np.roll(base, t, axis=1), np.ones((8, 8, 1)))
        imwrite(str(seq / f"im{t + 1:05d}.png"),
                (img[:64, :64] * 255).astype(np.uint8))
    cfg = root / "cfg.json"
    cfg.write_text(json.dumps({"root_path": str(root), "test_classes": {
        "ds": {"test": 1, "base_path": "data",
               "sequences": {"seq0": {"gop": 2, "frames": 3}}}}}))

    def argv(name):
        return ["--device", "cpu", "--test_config", str(cfg),
                "--output_path", str(root / f"{name}.json"), "--rate_num",
                "2", "--write_stream", "1", "--stream_path",
                str(root / f"{name}_bin")]

    with start_ranks(video_case, 2, argv("two")) as started:
        one = ttv.main(argv("one"))
        started.join()
    return root, one


def _no_time(log):
    """The log without its wall times ("decoded" holds the test time, as
    in the reference)."""
    return {ds: {seq: {r: {k: v for k, v in res.items()
                           if k not in ("test_time", "decoded")}
                       for r, res in rates.items()}
                 for seq, rates in seqs.items()}
            for ds, seqs in log.items()}


def test_video_rank_split_matches_one_process(harness):
    root, one = harness
    merged = {}
    for rank in range(2):
        with open(root / f"two.json.rank{rank}") as f:
            part = json.load(f)
        rates = part["ds"]["seq0"]
        assert list(rates) == [f"{rank:03d}"]  # tasks[rank::2]
        merged.update(rates)
    assert not (root / "two.json").exists()
    with open(root / "one.json") as f:
        want = json.load(f)
    assert set(one["ds"]["seq0"]) == {"000", "001"}
    assert json.dumps(_no_time({"ds": {"seq0": merged}}),
                      sort_keys=True) == json.dumps(_no_time(want),
                                                    sort_keys=True)
    for rate in range(2):
        for t in range(3):
            a = root / "one_bin" / "seq0" / str(rate) / f"{t}.bin"
            b = root / "two_bin" / "seq0" / str(rate) / f"{t}.bin"
            assert a.read_bytes() == b.read_bytes(), (rate, t)


@pytest.fixture(scope="module")
def fleet_codecs():
    """Unsharded codecs and fleet codecs over ["cpu", "cpu"], the full
    widths on the seeded damped inits, tables built."""
    plain = (IntraCodec(make_intra("cpu"), device="cpu"),
             VideoCodec(make_dmc("cpu"), device="cpu"))
    fleet = tuple(type(c)(copy.deepcopy(c.model), device="cpu")
                  for c in plain)
    for c in plain + fleet:
        c.update()
    for c in fleet:
        assert c.set_fleet_sharding(["cpu", "cpu"]) == 2
    return plain, fleet


def test_fleet_batch_matches_unsharded(fleet_codecs):
    """I + P at N = 2 (two rate points): the same streams, recons and
    DPB; the entropy-estimated forward too."""
    (pi, pv), (fi, fv) = fleet_codecs
    x = _frames(2, seed=5)[:, :2]
    iq = np.asarray([0.5, 0.3], np.float32).reshape(-1, 1, 1, 1)
    mvq = np.asarray([0.7, 0.45], np.float32).reshape(-1, 1, 1, 1)
    outs = []
    for ic, vc in ((pi, pv), (fi, fv)):
        i_streams = ic.compress_batch(x[0], iq)
        recon = ic.decompress_batch(i_streams, 64, 64, iq)
        dpb = make_dpb(torch.clamp(recon, 0, 1), 64, 96)
        enc = vc.compress_batch(x[1], dpb, mvq, mvq, True)
        dec = vc.decompress_batch(dpb, enc["bit_streams"], 64, 64, mvq, mvq,
                                  True)
        est = vc.forward(x[1], dpb, mvq, mvq, True)
        outs.append((i_streams, recon, enc, dec, est))
    (i0, r0, e0, d0, f0), (i1, r1, e1, d1, f1) = outs
    assert i0 == i1 and e0["bit_streams"] == e1["bit_streams"]
    assert torch.equal(r0, r1)
    for k in d0["dpb"]:
        assert torch.equal(d0["dpb"][k], d1["dpb"][k]), k
        assert torch.equal(e0["dpb"][k], d1["dpb"][k]), k
    assert torch.equal(f0["bpp"], f1["bpp"])
    assert torch.equal(f0["dpb"]["ref_frame"], f1["dpb"]["ref_frame"])


def test_fleet_rows_that_do_not_tile_run_unsharded(fleet_codecs,
                                                   monkeypatch):
    """N = 3 on a fleet of 2: the codec's own model runs the call."""
    (pi, _), (fi, _) = fleet_codecs
    calls = []
    for replica in fi._fleet:
        monkeypatch.setattr(replica, "compress_batch",
                            lambda *a, **k: calls.append(1))
    x = _frames(1, seed=6)[0, :3]
    assert fi.compress_batch(x, 0.5) == pi.compress_batch(x, 0.5)
    assert calls == []


class _OneRankMesh:
    """A one-rank spatial mesh: what set_spatial_sharding reads of one."""

    def get_group(self):
        return None

    def size(self):
        return 1

    def get_local_rank(self):
        return 0


def test_spatial_and_fleet_modes_refuse_each_other(fleet_codecs):
    """A fleet codec refuses spatial mode and a spatial codec refuses a
    fleet (the JAX engine asserts the first way only)."""
    for codec in fleet_codecs[1]:
        with pytest.raises(ValueError, match="exclude each other"):
            codec.set_spatial_sharding(_OneRankMesh())
    for codec in fleet_codecs[0]:
        spatial = type(codec)(copy.deepcopy(codec.model), device="cpu")
        spatial.set_spatial_sharding(_OneRankMesh())
        with pytest.raises(ValueError, match="exclude each other"):
            spatial.set_fleet_sharding(["cpu", "cpu"])


def test_video_fleet_needs_batch_rates_and_one_device_disables(harness,
                                                              capsys):
    root, one = harness
    argv = ["--device", "cpu", "--test_config", str(root / "cfg.json"),
            "--output_path", str(root / "fleet.json"), "--rate_num", "2",
            "--fleet", "1"]
    with pytest.raises(SystemExit, match="--batch_rates"):
        ttv.main(argv)
    log = ttv.main(argv + ["--batch_rates", "1", "--force_frame_num", "1"])
    assert "fleet serving disabled" in capsys.readouterr().out
    assert log["ds"]["seq0"]["000"]["i_frame_num"] == 1
