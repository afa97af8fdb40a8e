"""PyTorch port, the training loop's resume and the trainer CLI (no JAX:
the loop's parity with the JAX package is tests/test_torch_train_loop.py).

Resume: a run interrupted after an epoch and resumed from that epoch's
checkpoint repeats the uninterrupted run bit for bit on the CPU (the plain
kernel versions are deterministic): the losses of every later iteration
and the final parameters. Mid-stage the checkpoint's optimizer moments are
restored; at a stage boundary the optimizer starts fresh, as the
uninterrupted run's does. The frames are as large as the crop
(IMAGE_SIZE), so every crop is the whole frame: the loader's crop
generator (the JAX package's design: one numpy generator per loader,
which a resumed run builds afresh) then draws the same windows.

CLI: python -m vcm_ts_tpu_torch.trainer --device cpu on a tiny YAML writes
cfg.yaml, metrics.jsonl and one checkpoint per epoch; run again (its main,
in this process) it resumes past the last epoch and trains nothing
(tests/test_trainer_cli.py's contract).
"""

from __future__ import annotations

import copy
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vcm_ts_tpu_torch import data as tdata
from vcm_ts_tpu_torch import trainer
from vcm_ts_tpu_torch.codec.png_io import imwrite
from vcm_ts_tpu_torch.models.dmc import DMC
from vcm_ts_tpu_torch.train.checkpoint import CheckPointer
from vcm_ts_tpu_torch.train.tensorboard import MetricWriter
from vcm_ts_tpu_torch.train import train_loop
from vcm_ts_tpu_torch.train.train_loop import do_train
from vcm_ts_tpu_torch.utils.config import default_training_cfg
from vcm_ts_tpu_torch.utils.weights import init_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CH = (16, 16, 24)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch CPU thread per test: under pytest-xdist every worker would
    otherwise start one thread per core, and the training steps then ran
    about 100 times slower than alone (575 s against 6 s measured)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SINGLE = ["1", "me", "single", "me", "none", "0.0001", "{}", "false"]
CASCADE = ["2", "all", "cascade", "rec", "all", "0.0001", "{}", "false"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    rng = np.random.default_rng(0)
    for s in range(2):
        d = root / "data" / "g" / f"seq{s}" / "raw"
        os.makedirs(d)
        base = rng.random((9, 9, 3))
        for t in range(3):
            img = np.kron(np.roll(base, t, axis=1), np.ones((8, 8, 1)))
            imwrite(str(d / f"{t:05d}.png"),
                    (img[:64, :64] * 255).astype(np.uint8))
    return root


@pytest.fixture(scope="module")
def model0():
    return init_params(DMC(anchor_num=2, channel_mv=CH[0], channel_N=CH[1],
                           channel_M=CH[2], device="cpu"), seed=0,
                       kernel_scale=0.5)


def _cfg(tree, out, stages):
    cfg = default_training_cfg()
    cfg.MODEL.CHANNELS = list(CH)
    cfg.DATASET.TYPE = "SequenceDataset"
    cfg.DATASET.TRAIN_ROOT_DIRS = [str(tree / "data")]
    cfg.DATASET.TRAIN_SUBDIR_LISTS = [""]
    cfg.DATASET.TEST_ROOT_DIRS = [str(tree / "data")]
    cfg.DATASET.TEST_SUBDIR_LISTS = [""]
    cfg.DATASET.SEQUENCE_LENGTH = 3
    cfg.INPUT.IMAGE_SIZE = [64, 64]
    cfg.SOLVER.LAMBDAS = [85.0, 170.0]
    cfg.SOLVER.STAGES = stages
    cfg.OUTPUT_DIR = str(out)
    cfg.freeze()
    return cfg


def _run(cfg, model, start_epoch=0, opt_state=None):
    return do_train(cfg, model, tdata.make_data_loader(cfg, 0),
                    CheckPointer(cfg.OUTPUT_DIR), start_epoch=start_epoch,
                    seed=0, test_loader=tdata.make_data_loader(
                        cfg, 0, is_train=False), resume_opt_state=opt_state,
                    writer=MetricWriter(cfg.OUTPUT_DIR, enable_tb=False))


@pytest.mark.parametrize("case", ["mid_stage", "stage_boundary"])
def test_resume_repeats_uninterrupted_run(tmp_path, tree, model0, case):
    """Three epochs; resume from the checkpoint of epoch 1 (the second).
    mid_stage: single x1, cascade x2 (epoch 2 continues epoch 1's stage,
    moments restored); stage_boundary: single x2, cascade x1 (epoch 2
    starts a stage, fresh moments)."""
    n_single = 1 if case == "mid_stage" else 2
    stages = [[f.format(n_single) for f in SINGLE],
              [f.format(3 - n_single) for f in CASCADE]]
    full = copy.deepcopy(model0)
    rec = _run(_cfg(tree, tmp_path / "full", stages), full)
    assert [e["stage"] for e in rec["epochs"]] == [0] * n_single + [1] * (
        3 - n_single)
    assert sorted(f for f in os.listdir(tmp_path / "full")
                  if f.endswith(".pt")) == [f"model_epoch_{e:03d}.pt"
                                            for e in range(3)]

    resumed = DMC(anchor_num=2, channel_mv=CH[0], channel_N=CH[1],
                  channel_M=CH[2], device="cpu")
    ckpt = str(tmp_path / "full" / "model_epoch_001.pt")
    cp = CheckPointer(str(tmp_path / "resume"))
    extra = cp.load(resumed, path=ckpt)
    assert extra == {"epoch": 2}
    opt_state = cp.load_opt_state(path=ckpt)
    # the optimizer of epoch 1's stage: one cascade chain (mid_stage), or
    # two epochs of two single steps (stage_boundary)
    assert opt_state["count"] == (1 if case == "mid_stage" else 4)
    cfg = _cfg(tree, tmp_path / "resume", stages)
    rec2 = _run(cfg, resumed, start_epoch=2, opt_state=opt_state)

    want = [it for it in rec["iterations"] if it["epoch"] == 2]
    assert len(want) == len(rec2["iterations"]) == 1
    for g, w in zip(rec2["iterations"], want):
        assert g == w  # loss, bpp, psnr bit for bit
    assert rec2["epochs"][0]["eval"] == rec["epochs"][2]["eval"]
    for (name, a), b in zip(resumed.state_dict().items(),
                            full.state_dict().values()):
        assert torch.equal(a, b), name

    if case == "mid_stage":
        # without the moments, the resumed epoch's update is another one
        fresh = DMC(anchor_num=2, channel_mv=CH[0], channel_N=CH[1],
                    channel_M=CH[2], device="cpu")
        cp.load(fresh, path=ckpt, use_latest=False)
        rec3 = _run(_cfg(tree, tmp_path / "nomoments", stages), fresh,
                    start_epoch=2)
        assert rec3["epochs"][0]["eval"] != rec["epochs"][2]["eval"]
        assert not torch.equal(fresh.y_q_scale, full.y_q_scale)


def test_checkpoint_tag_wins_and_loads_strict(tmp_path, model0):
    cp = CheckPointer(str(tmp_path))
    assert not cp.has_checkpoint() and cp.load(model0, path=None) == {}
    cp.save("model_epoch_000", model0, None, epoch=1)
    m = copy.deepcopy(model0)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(1.0)
    cp.save("model_epoch_001", m, None, epoch=2)
    other = str(tmp_path / "model_epoch_000.pt")
    target = DMC(anchor_num=2, channel_mv=CH[0], channel_N=CH[1],
                 channel_M=CH[2], device="cpu")
    # the tag (the newest save) wins over an explicit path
    assert cp.load(target, path=other) == {"epoch": 2}
    assert torch.equal(target.y_q_scale, m.y_q_scale)
    assert cp.load(target, path=other, use_latest=False) == {"epoch": 1}
    assert cp.load_opt_state(path=other) is None
    bad = {k: v for k, v in model0.state_dict().items() if k != "y_q_scale"}
    torch.save({"params": bad, "opt_state": None, "extra": {}},
               str(tmp_path / "partial.pt"))
    with pytest.raises(RuntimeError, match="y_q_scale"):
        cp.load(target, path=str(tmp_path / "partial.pt"), use_latest=False)


def test_trainer_cli_runs_and_resumes(tmp_path, tree, monkeypatch):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"""
MODEL:
  CHANNELS: [16, 16, 24]
DATASET:
  TYPE: SequenceDataset
  TRAIN_ROOT_DIRS: ['{tree / "data"}']
  TRAIN_SUBDIR_LISTS: ['']
  SEQUENCE_LENGTH: 2
INPUT:
  IMAGE_SIZE: [64, 64]
SOLVER:
  LAMBDAS: [85, 170]
  STAGES:
    - ['1', 'me', 'single', 'me', 'none', '0.0001', '1', 'false']
    - ['1', 'all', 'cascade', 'rec', 'all', '0.0001', '1', 'false']
TENSORBOARD:
  BEST_SAMPLES_NUM: 2
  WORST_SAMPLES_NUM: 2
OUTPUT_DIR: '{tmp_path}/out'
""")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # one core, as the test workers share them
    # no tensorboard package, as on the card: the metrics go to
    # metrics.jsonl alone (here tensorboard pulls in TensorFlow, ~20 s)
    stub = tmp_path / "no_tensorboard" / "tensorboard"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("raise ImportError('tensorboard')\n")
    env["PYTHONPATH"] = str(stub.parent)
    argv = [sys.executable, "-m", "vcm_ts_tpu_torch.trainer", "--device",
            "cpu", "--config-file", str(cfg)]
    r = subprocess.run(argv, capture_output=True, text=True, timeout=600,
                       env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    out = tmp_path / "out"
    for f in ("cfg.yaml", "last_checkpoint.txt", "metrics.jsonl"):
        assert (out / f).exists(), f
    assert not [f for f in os.listdir(out) if f.startswith("events.")]
    assert sorted(f for f in os.listdir(out) if f.endswith(".pt")) == [
        "model_epoch_000.pt", "model_epoch_001.pt"]
    saved = default_training_cfg()
    saved.merge_from_file(str(out / "cfg.yaml"))
    assert saved.SOLVER.STAGES[1][2] == "cascade"
    assert saved.MODEL.CHANNELS == [16, 16, 24]
    lines = (out / "metrics.jsonl").read_text().count("\n")

    # run again (in this process: one more interpreter would import
    # tensorboard again, about 20 s here): it resumes past the last epoch
    # and trains nothing
    monkeypatch.setattr(train_loop, "MetricWriter", functools.partial(
        MetricWriter, enable_tb=False))
    again = trainer.main(argv[3:])
    assert again == {"epochs": [], "iterations": []}
    assert (out / "metrics.jsonl").read_text().count("\n") == lines
    assert sorted(f for f in os.listdir(out) if f.endswith(".pt")) == [
        "model_epoch_000.pt", "model_epoch_001.pt"]
