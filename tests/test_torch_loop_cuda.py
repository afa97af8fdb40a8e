"""The eval harness and the training loop on the card against the same
code on the CPU (the plain kernel versions).

Needs a CUDA device and nvcc, so every test carries the `cuda` marker and
skips without a card. Imports no JAX (run on the card with --noconftest):

    python -m pytest tests/test_torch_loop_cuda.py -q -m cuda --noconftest

Tolerances: the harness as chip_smoke.py's small-input reference (phase
3): decoded frames within 1e-3, so PSNR within 1e-2 dB at these levels
and entropy-estimated bits rtol 1e-3 (cuDNN's f32 convs sum in other
orders than the CPU's, TF32 off); the loop as phase 8's 64x64 step: every
iteration's mean loss, bpp and PSNR rtol 1e-3; the loader's batches are
host arrays and cross to the card bit for bit.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import pytest
import torch

from vcm_ts_tpu_torch import data as tdata
from vcm_ts_tpu_torch import test_video as ttv
from vcm_ts_tpu_torch.codec.engine import IntraCodec, VideoCodec
from vcm_ts_tpu_torch.codec.png_io import imwrite
from vcm_ts_tpu_torch.models.dmc import DMC
from vcm_ts_tpu_torch.models.intra import IntraNoAR
from vcm_ts_tpu_torch.ops import cuda_build
from vcm_ts_tpu_torch.train import train_step as ts
from vcm_ts_tpu_torch.train.tensorboard import MetricWriter
from vcm_ts_tpu_torch.train.train_loop import do_train
from vcm_ts_tpu_torch.utils.config import default_training_cfg
from vcm_ts_tpu_torch.utils.device import set_codec_numerics
from vcm_ts_tpu_torch.utils.weights import init_params

CH = (16, 16, 24)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cuda_build.build_all()
    set_codec_numerics()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A harness sequence (im1..im4.png, 60x60) and a training tree (two
    sequences of 3 frames, 64x64)."""
    root = tmp_path_factory.mktemp("loopcuda")
    rng = np.random.default_rng(0)
    os.makedirs(root / "seq")
    base = rng.random((16, 16, 3))
    for t in range(4):
        img = np.kron(np.roll(base, t, axis=1), np.ones((4, 4, 1)))[:60, :60]
        imwrite(str(root / "seq" / f"im{t + 1}.png"),
                (img * 255).astype(np.uint8))
    for s in range(2):
        d = root / "data" / "g" / f"seq{s}" / "raw"
        os.makedirs(d)
        base = rng.random((9, 9, 3))
        for t in range(3):
            img = np.kron(np.roll(base, t, axis=1), np.ones((8, 8, 1)))
            imwrite(str(d / f"{t:05d}.png"),
                    (img[:64, :64] * 255).astype(np.uint8))
    return root


def _codecs(device):
    i = init_params(IntraNoAR(N=32, device="cpu"), seed=0, kernel_scale=0.5)
    p = init_params(DMC(anchor_num=4, channel_mv=CH[0], channel_N=CH[1],
                        channel_M=CH[2], device="cpu"), seed=1,
                    kernel_scale=0.5)
    ic, vc = IntraCodec(i, device=device), VideoCodec(p, device=device)
    ic.update()
    vc.update()
    return ic, vc


@pytest.mark.cuda
def test_harness_on_card_matches_cpu(card, tree):
    task = {"frame_num": 4, "gop_size": 3, "img_path": str(tree / "seq"),
            "i_frame_q_scale": 0.8, "p_frame_y_q_scale": 0.9,
            "p_frame_mv_y_q_scale": 1.0, "write_stream": False}
    logs = {}
    for dev in ("cpu", "cuda"):
        ic, vc = _codecs(dev)
        logs[dev] = ttv.run_test(vc, ic, dict(task))
    a, b = logs["cuda"], logs["cpu"]
    assert a["frame_type"] == b["frame_type"] == [0, 1, 1, 0]
    np.testing.assert_allclose(a["frame_bpp"], b["frame_bpp"], rtol=1e-3)
    np.testing.assert_allclose(a["frame_psnr"], b["frame_psnr"], rtol=0,
                               atol=1e-2)


@pytest.mark.cuda
def test_harness_batched_on_card_equals_sequential(card, tree, tmp_path):
    """Real streams: the batched run's .bin files and log equal the
    sequential run's on the card (rows code as if alone)."""
    ic, vc = _codecs("cuda")
    qs = ((0.7, 0.8, 0.9), (1.3, 1.2, 1.1))

    def tasks(tag):
        out = []
        for r, q in enumerate(qs):
            d = tmp_path / f"{tag}{r}"
            os.makedirs(d)
            out.append({"frame_num": 4, "gop_size": 2,
                        "img_path": str(tree / "seq"), "i_frame_q_scale": q[0],
                        "p_frame_y_q_scale": q[1],
                        "p_frame_mv_y_q_scale": q[2], "write_stream": True,
                        "bin_folder": str(d)})
        return out

    seq = [ttv.run_test(vc, ic, t) for t in tasks("seq")]
    bat = ttv.run_test_batched(vc, ic, tasks("bat"))
    for r in range(len(qs)):
        for k in ("frame_type", "frame_bpp", "frame_psnr", "frame_msssim"):
            np.testing.assert_array_equal(bat[r][k], seq[r][k], err_msg=k)
        for f in range(4):
            assert (tmp_path / f"bat{r}" / f"{f}.bin").read_bytes() == \
                (tmp_path / f"seq{r}" / f"{f}.bin").read_bytes()


def _cfg(tree, out):
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
    cfg.SOLVER.STAGES = [
        ["1", "me", "single", "me", "none", "0.0001", "1", "false"],
        ["2", "all", "cascade", "rec", "all", "0.0001", "1", "false"]]
    cfg.OUTPUT_DIR = str(out)
    cfg.freeze()
    return cfg


@pytest.mark.cuda
def test_loop_on_card_matches_cpu(card, tree, tmp_path, monkeypatch):
    """do_train on the card and on the CPU from one state, with the same
    noise (drawn on the CPU and moved to each run's device)."""
    model0 = init_params(DMC(anchor_num=2, channel_mv=CH[0],
                             channel_N=CH[1], channel_M=CH[2],
                             device="cpu"), seed=0, kernel_scale=0.5)
    draw, draw_cascade = ts.draw_noise, ts.draw_cascade_noise
    records = {}
    for dev in ("cpu", "cuda"):
        cpu_gen = torch.Generator().manual_seed(7)

        def noise(model, x, generator, _g=cpu_gen):
            return tuple(t.to(x.device) for t in draw(model, x.cpu(), _g))

        def cascade(model, xs, generator, accum_steps=1, _g=cpu_gen):
            return [tuple(t.to(xs.device) for t in n) for n in draw_cascade(
                model, xs.cpu(), _g, accum_steps)]

        monkeypatch.setattr(ts, "draw_noise", noise)
        monkeypatch.setattr(ts, "draw_cascade_noise", cascade)
        model = copy.deepcopy(model0).to(dev)
        cfg = _cfg(tree, tmp_path / dev)
        records[dev] = do_train(
            cfg, model, tdata.make_data_loader(cfg, 0), None, seed=0,
            test_loader=tdata.make_data_loader(cfg, 0, is_train=False),
            writer=MetricWriter(cfg.OUTPUT_DIR, enable_tb=False))
    a, b = records["cuda"], records["cpu"]
    assert [e["stage"] for e in a["epochs"]] == [0, 1]
    assert len(a["iterations"]) == len(b["iterations"]) == 2
    for x, y in zip(a["iterations"], b["iterations"]):
        for k in ("loss", "bpp", "psnr"):
            np.testing.assert_allclose(x[k], y[k], rtol=1e-3, err_msg=k)


@pytest.mark.cuda
def test_loader_batches_cross_to_the_card(card, tree):
    cfg = _cfg(tree, tree / "unused")
    for is_train in (True, False):
        loader = tdata.make_data_loader(cfg, 3, is_train=is_train)
        loader.set_epoch(1)
        for x, y in loader:
            for host in (x, y):
                on_card = ts.to_f32(host, card)
                assert on_card.device.type == "cuda"
                assert np.array_equal(on_card.cpu().numpy(), host)
