"""The VCM slice's modules on the card against the same modules on the CPU.

Needs a CUDA device (the codec path launches the hand-written kernels,
which have no CPU mode), so every test carries the `cuda` marker and skips
without a card. Imports no JAX, so it runs where the port runs
(tests/conftest.py imports JAX, hence --noconftest there):

    python -m pytest tests/test_torch_vcm_cuda.py -q -m cuda --noconftest

Tolerances: the resizes equal on both devices (the same integer
arithmetic; INTER_AREA's f32 matmuls atol 1e-3 on 0..255 values); YOLO
and MTCNN: the same detections, boxes within 0.5 px; OCR: equal strings,
logits atol 1e-3; the pipeline on a small folder: byte-identical base and
enhancement streams and box pickles between the card and the CPU
(damped weights, TF32 off), PNGs within one level.
"""

from __future__ import annotations

import os
import pickle
import shutil
from glob import glob

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAINED = os.path.join(REPO, "pretrained")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from vcm_ts_tpu_torch.ops import cuda_build
    from vcm_ts_tpu_torch.utils.device import set_codec_numerics

    cuda_build.build_all()
    set_codec_numerics()
    return torch.device("cuda")


def _scene(h=256, w=448):
    """A seeded frame with the committed sprites (chip_smoke.py's
    composition at a smaller scale)."""
    import chip_smoke

    frames, lp, fc, texts = chip_smoke.compose_frames(2, h, w)
    return frames, lp, fc, texts


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["area", "area_crops", "linear", "cubic"])
def test_cv_resize_card_equals_cpu(card, kind):
    from vcm_ts_tpu_torch.ops import cv_resize as cr

    rng = np.random.default_rng(0)
    if kind.startswith("area"):
        img = torch.from_numpy((rng.random((300, 500, 3)) * 255).astype(
            np.float32))
        if kind == "area":
            fn = lambda t: cr.resize_area(t, 181, 302)  # noqa: E731
        else:
            boxes = np.array([[1, 1, 500, 300], [20, 30, 90, 80],
                              [480, 290, 500, 300], [7, 7, 3, 9]])
            fn = lambda t: cr.crop_resize_area(t, boxes, 48)  # noqa: E731
        torch.testing.assert_close(fn(img.to(card)).cpu(), fn(img),
                                   rtol=0, atol=1e-3)
    else:
        img = torch.from_numpy(rng.integers(0, 256, (150, 540, 3),
                                            dtype=np.uint8))
        fn = cr.resize_linear_u8 if kind == "linear" else cr.resize_cubic_u8
        assert torch.equal(fn(img.to(card), 37, 115).cpu(),
                           fn(img, 37, 115))


@pytest.mark.cuda
def test_detectors_card_equal_cpu(card):
    from vcm_ts_tpu_torch.eval.mtcnn_native import MTCNNNativeDetector
    from vcm_ts_tpu_torch.eval.yolo_native import YOLOv8NativeDetector

    frames, _, _, _ = _scene()
    for cls, name in ((YOLOv8NativeDetector, "yolov8-lp.npz"),
                      (MTCNNNativeDetector, "mtcnn.npz")):
        outs = []
        for dev in ("cpu", "cuda"):
            det = cls.load(os.path.join(PRETRAINED, name), device=dev)
            outs.append(det.detect(frames[0])[:2])
        (bc, sc), (bg, sg) = outs
        assert len(bc) == len(bg) >= 1, name
        np.testing.assert_allclose(bg, bc, rtol=0, atol=0.5)
        np.testing.assert_allclose(sg, sc, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_ocr_card_equals_cpu(card):
    from vcm_ts_tpu_torch.eval.ocr_native import PlateOCRNative

    frames, lp, _, texts = _scene(544, 960)
    rgb = torch.from_numpy(frames[0]).float() / 255.0
    cpu = PlateOCRNative.load(os.path.join(PRETRAINED, "plate_ocr.npz"),
                              device="cpu")
    gpu = PlateOCRNative.load(os.path.join(PRETRAINED, "plate_ocr.npz"),
                              device="cuda")
    want = cpu(rgb, lp[0])
    assert gpu(rgb.to(card), lp[0]) == want
    assert sum(a == b for a, b in zip(want, texts)) >= 2
    x = torch.rand((3, 32, 160), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(gpu.logits(x.to(card)).cpu(), cpu.logits(x),
                               rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_pipeline_card_equals_cpu(card, tmp_path):
    """detect_rois, the base layer, residuals, the learned enhancement layer
    and fusion on a 2-frame folder, on the card and on the CPU."""
    import chip_smoke
    from vcm_ts_tpu_torch.codec import vcm_pipeline as vp
    from vcm_ts_tpu_torch.codec.png_io import imread, write_png
    from vcm_ts_tpu_torch.ops import cuda_build
    from vcm_ts_tpu_torch.utils.weights import make_dmc, make_intra

    frames, _, _, _ = _scene()
    ckpt = {"i": str(tmp_path / "i.pth"), "p": str(tmp_path / "p.pth")}
    chip_smoke.save_codec_pth(make_intra("cpu"), ckpt["i"])
    chip_smoke.save_codec_pth(make_dmc("cpu"), ckpt["p"])
    roots = {}
    for dev in ("cpu", "cuda"):
        root = str(tmp_path / dev)
        src = os.path.join(root, vp.PATHS_ARTIFACTS_SOURCE_FRAMES)
        os.makedirs(src)
        for i, f in enumerate(frames):
            write_png(os.path.join(src, f"im{i + 1:05d}.png"), f)
        cuda_build.reset_launches()
        chip_smoke.vcm_pipeline(root, ckpt, dev)
        if dev == "cuda":
            assert all(cuda_build.LAUNCHES[k] > 0 for k in (
                "warp", "subpel_conv1x1", "pixel_shuffle_relayout"))
        roots[dev] = root
    c, g = roots["cpu"], roots["cuda"]
    files = sorted(os.path.relpath(p, c) for p in glob(
        os.path.join(c, "**", "*"), recursive=True) if os.path.isfile(p))
    assert files == sorted(os.path.relpath(p, g) for p in glob(
        os.path.join(g, "**", "*"), recursive=True) if os.path.isfile(p))
    for rel in files:
        a, b = os.path.join(c, rel), os.path.join(g, rel)
        if rel.endswith(".bin") or "_coords" in rel:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                if "_coords" in rel:
                    np.testing.assert_array_equal(pickle.load(fa),
                                                  pickle.load(fb))
                else:
                    assert fa.read() == fb.read(), rel
        elif rel.endswith(".png"):
            d = np.abs(imread(a).astype(int) - imread(b).astype(int))
            assert d.max() <= 1, rel
    shutil.rmtree(tmp_path)
