"""PyTorch port, the OCR domain gate (vcm_ts_tpu_torch.ocr_domain_gate)
against the JAX package's tools/ocr_domain_gate.py.

The port draws the gate's plates without PIL, from the glyph atlas
(data/plate_glyphs.npz: seven faces, boxes and kerning read from PIL by
data/make_plate_glyphs.py) laid out as PIL's string layout. Measured gap
against PIL 12.1.0's render_plate_font: none (0 of 6000
renders over the four gate faces differed in shape or in any pixel). So
the crops are held equal to PIL's exactly, shape and pixels (tolerance
0 levels). On the two undistorted conditions the port's recognizer, on
the shipped weights, reads what the JAX gate's reads.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from tests.test_torch_warp_twopass import one_torch_thread  # noqa: F401
from tools import ocr_domain_gate as jgate
from tools.train_plate_ocr import HELDOUT_FONTS
from tools.train_plate_ocr import random_text as j_random_text
from vcm_ts_tpu.eval.ocr_native import PlateOCRNative as JOCR
from vcm_ts_tpu_torch import ocr_domain_gate as tgate
from vcm_ts_tpu_torch import train_plate_ocr as tpo
from vcm_ts_tpu_torch.eval.ocr_native import PlateOCRNative

NPZ = "pretrained/plate_ocr.npz"
GAP = 0  # measured pixel gap to PIL, in 8-bit levels
# (JAX tool's font path, the port's atlas face); None: PIL's default face
FACES = [(None, None)] + list(zip(HELDOUT_FONTS, tgate.HELDOUT_FACES))


@pytest.mark.parametrize("face", range(len(FACES)))
def test_render_plate_font_equals_pil(face):
    """64 texts per face, each drawn from one seed by both renderers:
    the same draws, the same crop shape, the same pixels."""
    path, atlas_face = FACES[face]
    for seed in range(64):
        r_j = np.random.default_rng(1000 * face + seed)
        r_t = np.random.default_rng(1000 * face + seed)
        text = j_random_text(r_j)
        assert tpo.random_text(r_t) == text
        want = jgate.render_plate_font(text, r_j, path)
        got = tgate.render_plate_font(text, r_t, atlas_face)
        assert got.shape == want.shape, (text, got.shape, want.shape)
        gap = np.abs(got.astype(int) - want.astype(int)).max()
        assert gap <= GAP, (text, gap)
        # the generators stay in step
        assert r_t.integers(1 << 30) == r_j.integers(1 << 30)


def _jax_crops(cond, n, seed=0):
    """The JAX gate's texts and crops of one undistorted condition."""
    fonts = jgate.held_out_fonts()
    make = {"train-font-clean": lambda t, r: jgate.render_plate_font(
                t, r, None),
            "heldout-fonts": lambda t, r: jgate.render_plate_font(
                t, r, fonts[int(r.integers(len(fonts)))])}[cond]
    rng = np.random.default_rng(seed)
    texts, crops = [], []
    for _ in range(n):
        t = j_random_text(rng)
        texts.append(t)
        crops.append(make(t, rng))
    return texts, crops


@pytest.fixture(scope="module")
def readers():
    return JOCR.load(NPZ), PlateOCRNative.load(NPZ, device="cpu")


@pytest.mark.parametrize("cond", ["train-font-clean", "heldout-fonts"])
def test_predictions_equal_the_jax_gate(readers, cond):
    """n = 16 plates: on every crop whose render is pixel-equal to the
    JAX gate's (all of them, at the measured gap), the port reads the
    JAX recognizer's string."""
    j_ocr, t_ocr = readers
    j_texts, j_crops = _jax_crops(cond, 16)
    texts, crops = tgate.condition_crops(tgate.conditions()[cond], 16)
    assert texts == j_texts
    same = [i for i, (a, b) in enumerate(zip(crops, j_crops))
            if a.shape == b.shape and np.array_equal(a, b)]
    assert len(same) == 16
    want = j_ocr.recognize_crops(j_crops)
    got = t_ocr.recognize_crops([torch.from_numpy(c) for c in crops])
    assert [got[i] for i in same] == [want[i] for i in same]
    assert np.mean([g == t for g, t in zip(got, texts)]) >= 0.5


# sha256 of the atlas arrays of the four training faces (faces 0-3, the
# first 649387 coverage bytes), as the trainers were built on them
TRAIN_FACES = {
    "pixels": "a4f1bec6edfbed04",
    "start": "3097b2391bca4abc",
    "shape": "66f226be3b3d4d05",
    "offset": "8b2a4b76e48f097e",
    "advance": "1b4023f8514142c3",
}


def test_training_faces_unchanged():
    a = tpo._atlas()
    arrays = {"pixels": a["pixels"][:649387]}
    arrays.update({k: a[k][:4] for k in TRAIN_FACES if k != "pixels"})
    for k, digest in TRAIN_FACES.items():
        got = hashlib.sha256(np.ascontiguousarray(arrays[k]).tobytes())
        assert got.hexdigest()[:16] == digest, k
    assert [str(f) for f in a["faces"][:4]] == [
        "default", "DejaVuSans.ttf", "DejaVuSerif-Bold.ttf",
        "DejaVuSansMono.ttf"]
    assert int(a["start"][4, 0, 0]) == 649387


def test_gate_reports_all_conditions(readers):
    rep = tgate.evaluate(NPZ, 4, device="cpu")
    assert rep["fonts"] == 3 and rep["n_per_condition"] == 4
    for cond in tgate.conditions():
        assert {"exact", "symbol_acc", "example"} <= set(rep[cond])
        assert 0.0 <= rep[cond]["exact"] <= rep[cond]["symbol_acc"] <= 1.0
