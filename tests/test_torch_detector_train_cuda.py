"""The detector and OCR trainers on the card: the card CTC (the
forward-backward route of train/ctc.py) against its plain version, each
trainer's step repeated from one state, and the export round trip.

Needs a CUDA device, so every test carries the `cuda` marker and skips
without a card. Imports no JAX (run on the card with --noconftest):

    python -m pytest tests/test_torch_detector_train_cuda.py -q -m cuda \
        --noconftest

Tolerances: CTC loss and d logits within 1e-4 of the largest value (the
plain recursion's f32 logaddexp chain against the route's float64
recursions); the repeated steps and the round trips bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vcm_ts_tpu_torch import train_face_detector as tfd
from vcm_ts_tpu_torch import train_plate_detector as tpd
from vcm_ts_tpu_torch import train_plate_ocr as tpo
from vcm_ts_tpu_torch.eval.mtcnn_native import MTCNNNativeDetector
from vcm_ts_tpu_torch.eval.ocr_native import PlateOCRNative
from vcm_ts_tpu_torch.eval.yolo_native import YOLOv8NativeDetector
from vcm_ts_tpu_torch.train import ctc
from vcm_ts_tpu_torch.utils.device import set_codec_numerics


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_codec_numerics()
    return torch.device("cuda")


def _labels(rng, b, n=9):
    labels = np.zeros((b, n), np.int32)
    pad = np.ones((b, n), np.float32)
    for i in range(b):
        m = int(rng.integers(1, n + 1))
        row = rng.integers(1, 37, m)
        if m > 2:
            row[1] = row[0]  # a repeated label
        labels[i, :m], pad[i, :m] = row, 0
    return labels, pad


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", [(4, 16), (64, 40), (3, 40)])
def test_card_ctc_matches_plain(card, b, t):
    rng = np.random.default_rng(b * t)
    logits = torch.from_numpy(rng.normal(0, 3, (b, t, 37)).astype(
        np.float32)).to(card)
    labels, pad = _labels(rng, b)

    def run(fn):
        x = logits.clone().requires_grad_(True)
        loss = fn(x, labels, pad)
        return loss.detach(), torch.autograd.grad(loss.sum(), x)[0]

    lc, gc = run(ctc.ctc_loss)
    lp, gp = run(ctc.ctc_loss_plain)
    assert (lc - lp).abs().max() <= 1e-4 * lp.abs().max()
    assert (gc - gp).abs().max() <= 1e-4 * gp.abs().max()
    assert torch.equal(run(ctc.ctc_loss)[1], gc)


def _ocr():
    model = tpo.freeze_input_bias(
        PlateOCRNative.init_random(0, "cuda").model).train()
    opt = tpo.make_optimizer(model, 1e-3)
    return model, opt, tpo.make_step(model, opt)


def _plate():
    det = tpd.make_model(0, "cuda")
    opt = tpd.make_optimizer(det, 2e-3, 20)
    return det, opt, tpd.make_step(det, opt)


def _face(net_name):
    def build():
        net = getattr(MTCNNNativeDetector(device="cuda").init(0), net_name)
        opt = tfd.make_optimizer(net, 1e-3)
        return net, opt, tfd.make_step(net, opt)
    return build


TRAINERS = {
    "plate_ocr": (_ocr, lambda r: tpo.make_batch(8, r, 160)[:3]),
    "plate_detector": (_plate, lambda r: tpd.make_batch(2, r)[:2]),
    **{f"face_{n}": (_face(n), lambda r, s=s: tfd.pad_batch(
        *tfd.sample_crops(r, 2, s), 16)) for n, s in tfd.CROP_SIZES.items()},
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TRAINERS))
def test_step_repeats_bit_for_bit(card, name):
    build, draw = TRAINERS[name]
    batch = draw(np.random.default_rng(1))
    states = []
    for _ in range(2):
        module, opt, step = build()
        for _ in range(3):
            step(*batch)
        state = {k: v.detach().cpu().clone()
                 for k, v in module.state_dict().items()}
        state.update({f"mu {k}": v.cpu().clone() for k, v in opt.mu.items()})
        state.update({f"nu {k}": v.cpu().clone() for k, v in opt.nu.items()})
        states.append(state)
    a, b = states
    assert [k for k in a if not torch.equal(a[k], b[k])] == []


@pytest.mark.cuda
def test_exports_round_trip(card, tmp_path):
    ocr = PlateOCRNative.init_random(3, "cuda")
    det = tpd.make_model(3, "cuda")
    faces = MTCNNNativeDetector(device="cuda").init(3)
    ocr.save(str(tmp_path / "ocr.npz"))
    tpd.export_npz(det, str(tmp_path / "lp.npz"))
    tfd.export_npz(faces, str(tmp_path / "mtcnn.npz"))
    pairs = [(ocr.model, PlateOCRNative.load(str(tmp_path / "ocr.npz"),
                                             "cuda").model),
             (det, YOLOv8NativeDetector.load(str(tmp_path / "lp.npz"),
                                             device="cuda")),
             (faces, MTCNNNativeDetector.load(str(tmp_path / "mtcnn.npz"),
                                              "cuda"))]
    for a, b in pairs:
        sa, sb = a.state_dict(), b.state_dict()
        assert set(sa) == set(sb)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
