"""PyTorch port, detectors, OCR and metrics against the JAX package on the
CPU, on the shipped weights (pretrained/yolov8-lp.npz, mtcnn.npz,
plate_ocr.npz).

The detectors' parity tests feed both stacks the same preprocessed tensor
and compare raw outputs, since a one-level pixel difference of a resize
can flip a score at a threshold; the end-to-end detections then go
through each stack's own preprocessing. Tolerances: YOLO boxes atol 1e-3
px and scores 1e-5 on one letterboxed canvas (f32 convs in other orders;
1.1e-4 px measured); MTCNN nets atol 1e-5; detect(): the same box count,
boxes within 1 px, scores within 1e-3 (YOLO) and 1e-4 (MTCNN). OCR
logits atol 1e-3 (1.1e-4 measured) and equal strings. Metrics: text
metrics equal; mAP, BD-rate equal to 1e-12; MS-SSIM and PSNR rtol 1e-5.

The JAX detectors are built without their eager flax init (about 25 s
each on a CPU): the parameter templates come from jax.eval_shape and
the values from the same .npz through the JAX package's importer.
"""

from __future__ import annotations

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_warp_twopass import one_torch_thread  # noqa: F401
from vcm_ts_tpu.eval import bd_metrics as j_bd
from vcm_ts_tpu.eval import detection_metrics as j_det
from vcm_ts_tpu.eval import mtcnn_native as j_mtcnn
from vcm_ts_tpu.eval import ocr_native as j_ocr
from vcm_ts_tpu.eval import text_metrics as j_text
from vcm_ts_tpu.eval import yolo_native as j_yolo
from vcm_ts_tpu.ops import msssim as j_msssim
from vcm_ts_tpu.utils.weight_import import import_state_dict
from vcm_ts_tpu_torch.eval import bd_metrics, detection_metrics
from vcm_ts_tpu_torch.eval import mtcnn_native, ocr_native, text_metrics
from vcm_ts_tpu_torch.eval import yolo_native
from vcm_ts_tpu_torch.ops import msssim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAINED = os.path.join(REPO, "pretrained")
LP_NPZ = os.path.join(PRETRAINED, "yolov8-lp.npz")
FACE_NPZ = os.path.join(PRETRAINED, "mtcnn.npz")
OCR_NPZ = os.path.join(PRETRAINED, "plate_ocr.npz")


def _template(init_fn):
    shapes = jax.eval_shape(init_fn)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


def jax_yolo(npz_path):
    """The JAX YOLOv8NativeDetector on the .npz, as its load() builds it."""
    data = np.load(npz_path)
    meta = json.loads(str(data["__meta__"]))
    det = j_yolo.YOLOv8NativeDetector(
        nc=meta["nc"], width=meta["width"], depth=meta["depth"],
        max_channels=meta["max_channels"], reg_max=meta["reg_max"],
        imgsz=int(meta["imgsz"]))
    key = jax.random.PRNGKey(0)
    x = jnp.zeros((1, 64, 64, 3))
    bb = _template(lambda: det.backbone.init(key, x))

    def head_init():
        taps = det.backbone.apply(bb, x)
        return det.head.init(key, [taps["3_deep"], taps["4_deep"],
                                   taps["5_deep"]])

    head = _template(head_init)
    bb_sd = {k[len("model."):]: data[k] for k in data.files
             if k.startswith("model.") and not k.startswith("model.22.")}
    head_sd = {k[len("model.22."):]: data[k] for k in data.files
               if k.startswith("model.22.")
               and not k.startswith("model.22.dfl.")}
    det.bb_params = import_state_dict(bb, bb_sd, strict="cover")
    det.head_params = import_state_dict(head, head_sd, strict="cover")
    return det


def jax_mtcnn(npz_path):
    data = np.load(npz_path)
    det = j_mtcnn.MTCNNNativeDetector()
    key = jax.random.PRNGKey(0)
    det.params = {}
    for net, size in (("pnet", 12), ("rnet", 24), ("onet", 48)):
        module = getattr(det, net)
        tmpl = _template(lambda m=module, s=size: m.init(
            key, jnp.zeros((1, s, s, 3))))
        sd = {k[len(net) + 1:]: data[k] for k in data.files
              if k.startswith(net + ".")}
        det.params[net] = import_state_dict(tmpl, sd, strict="cover")
    return det


def sprite_frame(seed, size_wh=(256, 192)):
    """A frame with one rendered plate and one rendered face, composited as
    tests/test_vcm_e2e_learned.py does; returns (frame, plate box, face
    box)."""
    import cv2

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from train_face_detector import _paste_rgba, render_face
    from train_plate_detector import _background, _paste, random_text, \
        render_plate

    rng = np.random.default_rng(seed)
    w, h = size_wh
    img = _background(rng, max(w, h))[:h, :w].copy()
    plate = render_plate(random_text(rng), rng, augment=False).astype(
        np.float32)
    plate = np.repeat(plate[:, :, None], 3, axis=2)
    s = 90.0 / plate.shape[1]
    plate = cv2.resize(plate, (90, max(8, int(plate.shape[0] * s))),
                       interpolation=cv2.INTER_AREA)
    lp = _paste(img, plate, rng)
    fc = _paste_rgba(img, render_face(rng, 56), rng, avoid=[lp])
    return img.clip(0, 255).astype(np.uint8), lp, fc


@pytest.fixture(scope="module")
def yolos():
    return (jax_yolo(LP_NPZ),
            yolo_native.YOLOv8NativeDetector.load(LP_NPZ, device="cpu"))


@pytest.fixture(scope="module")
def mtcnns():
    return (jax_mtcnn(FACE_NPZ),
            mtcnn_native.MTCNNNativeDetector.load(FACE_NPZ, device="cpu"))


@pytest.fixture(scope="module")
def frame():
    return sprite_frame(7)


def test_yolo_raw_matches_jax(yolos):
    """Backbone + head + DFL decode on one shared letterboxed canvas."""
    j_det_, t_det = yolos
    canvas = np.random.default_rng(0).random((1, 320, 320, 3)).astype(
        np.float32)
    jb, js = (np.asarray(a) for a in j_det_.raw(canvas))
    tb, ts = (a.numpy() for a in t_det.raw(torch.from_numpy(canvas)))
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-3)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)


def test_yolo_detect_matches_jax(yolos, frame):
    """End to end, each stack with its own letterbox (cv2 / the port's
    INTER_LINEAR): the same plates, boxes within 1 px."""
    j_det_, t_det = yolos
    img, lp, _ = frame
    jb, js, jl = j_det_.detect(img, conf=0.25)
    tb, ts, tl = t_det.detect(img, conf=0.25)
    assert len(jb) == len(tb) >= 1
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1.0)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(tl, jl)
    iou = detection_metrics.box_iou(tb, np.asarray([lp], np.float32))
    assert iou.max() >= 0.5
    # detect_padded: the frame at its own size, no letterbox
    jb, js, _ = j_det_.detect_padded(img, conf=0.25)
    tb, ts, _ = t_det.detect_padded(img, conf=0.25)
    assert len(jb) == len(tb)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1.0)


@pytest.mark.parametrize("net,size,n", [("pnet", 31, 2), ("rnet", 24, 5),
                                        ("onet", 48, 3)])
def test_mtcnn_nets_match_jax(mtcnns, net, size, n):
    """Each net on the same normalised input: VALID convs, per-channel
    PReLU, ceil-mode pools (31 px: partial windows), (W, H, C) flatten."""
    j_det_, t_det = mtcnns
    x = np.random.default_rng(size).standard_normal(
        (n, size, size, 3)).astype(np.float32)
    want = getattr(j_det_, net).apply(j_det_.params[net], x)
    got = getattr(t_det, net)(torch.from_numpy(x).permute(0, 3, 1, 2))
    for w, g in zip(want, got):
        g = g.detach()
        if g.dim() == 4:
            g = g.permute(0, 2, 3, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_mtcnn_detect_matches_jax(mtcnns, frame):
    """The three-stage cascade on a 256x192 sprite frame, each stack with
    its own pyramid and crop resizes."""
    j_det_, t_det = mtcnns
    img, _, fc = frame
    jb, js = j_det_.detect(img)
    tb, ts = t_det.detect(img)
    assert len(jb) == len(tb) >= 1
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1.0)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-4)
    assert detection_metrics.box_iou(
        tb, np.asarray([fc], np.float32)).max() >= 0.5


def test_mtcnn_box_math_matches_jax():
    rng = np.random.default_rng(2)
    reg = rng.standard_normal((9, 11, 4)).astype(np.float32) * 0.1
    probs = rng.random((9, 11)).astype(np.float32)
    a = mtcnn_native.generate_bounding_boxes(reg, probs, 0.43, 0.6)
    b = j_mtcnn.generate_bounding_boxes(reg, probs, 0.43, 0.6)
    np.testing.assert_array_equal(a, b)
    for mode in ("union", "min"):
        np.testing.assert_array_equal(
            mtcnn_native.nms_mtcnn(a[:, :4], a[:, 4], 0.5, mode),
            j_mtcnn.nms_mtcnn(b[:, :4], b[:, 4], 0.5, mode))
    np.testing.assert_array_equal(mtcnn_native.rerec(mtcnn_native.bbreg(
        a[:, :5], a[:, 5:])), j_mtcnn.rerec(j_mtcnn.bbreg(b[:, :5], b[:, 5:])))


@pytest.fixture(scope="module")
def ocrs():
    return (j_ocr.PlateOCRNative.load(OCR_NPZ),
            ocr_native.PlateOCRNative.load(OCR_NPZ, device="cpu"))


def test_ocr_logits_match_jax(ocrs):
    """The flax tree mapped onto nn.LSTM (gates i, f, g, o; the flax bias
    in bias_hh; cell 1 = the reverse direction) gives the JAX logits."""
    from tools.train_plate_ocr import make_batch

    j_o, t_o = ocrs
    images, _, _, texts = make_batch(8, np.random.default_rng(20260820),
                                     ocr_native.WIDTH_BUCKETS[-1])
    want = np.asarray(j_o._jit(j_o.params, images))
    got = t_o.logits(torch.from_numpy(images[..., 0])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert ocr_native.ctc_greedy_decode(got) == j_ocr.ctc_greedy_decode(want)
    for text in texts:
        for a, b in zip(ocr_native.encode_text(text, 9),
                        j_ocr.encode_text(text, 9)):
            np.testing.assert_array_equal(a, b)


def test_ocr_reads_frame_crops_like_jax(ocrs):
    """Rendered plates pasted into a frame: crop, gray, INTER_CUBIC to
    height 32, width buckets, greedy CTC: the same strings."""
    from tools.train_plate_ocr import random_text, render_plate

    j_o, t_o = ocrs
    rng = np.random.default_rng(11)
    frame = np.full((120, 900, 3), 0.5, np.float32)
    boxes, x = [], 5
    for _ in range(4):
        p = render_plate(random_text(rng), rng, augment=False)
        h, w = p.shape
        frame[10:10 + h, x:x + w] = p[:, :, None] / 255.0
        boxes.append([x, 10, x + w, 10 + h])
        x += w + 10
    want = j_o(frame, np.asarray(boxes))
    assert t_o(frame, np.asarray(boxes)) == want
    assert t_o(torch.from_numpy(frame), np.asarray(boxes)) == want


TEXT_PAIRS = [("AB123C", "AB123C"), ("AB123C", "A8123C"), ("", "A"),
              ("XYZ", ""), ("MARTHA", "MARHTA"), ("DWAYNE", "DUANE")]


@pytest.mark.parametrize("metric", ["text", "map", "bd", "msssim"])
def test_metrics_match_jax(metric):
    rng = np.random.default_rng(4)
    if metric == "text":
        refs, hyps = zip(*TEXT_PAIRS)
        assert (text_metrics.calculate_ocr_metrics(refs, hyps)
                == j_text.calculate_ocr_metrics(refs, hyps))
        for a, b in TEXT_PAIRS:
            assert text_metrics.jaro_winkler(a, b) == j_text.jaro_winkler(
                a, b)
            assert text_metrics.cer(a, b) == j_text.cer(a, b)
    elif metric == "map":
        port, ref = (detection_metrics.MeanAveragePrecision(),
                     j_det.MeanAveragePrecision())
        for _ in range(3):
            gt = rng.random((4, 2)) * 100
            gt = np.concatenate([gt, gt + 10 + rng.random((4, 2)) * 40], 1)
            det = gt + rng.normal(0, 4, gt.shape)
            preds = {"boxes": det, "scores": rng.random(4),
                     "labels": rng.integers(0, 2, 4)}
            target = {"boxes": gt, "labels": rng.integers(0, 2, 4)}
            port.update(preds, target)
            ref.update(preds, target)
        a, b = port.compute(), ref.compute()
        for k in ("map", "map_50"):
            assert a[k] == pytest.approx(b[k], abs=1e-12)
        np.testing.assert_allclose(a["map_per_class"], b["map_per_class"])
    elif metric == "bd":
        r1, q1 = [100, 200, 400, 800], [30.0, 33.0, 35.5, 37.0]
        r2, q2 = [90, 170, 350, 700], [30.2, 33.1, 35.9, 37.4]
        for method in ("pchip", "akima", "cubic"):
            assert bd_metrics.bd_rate(r1, q1, r2, q2, method) == \
                pytest.approx(j_bd.bd_rate(r1, q1, r2, q2, method),
                              abs=1e-12)
            assert bd_metrics.bd_quality(r1, q1, r2, q2, method) == \
                pytest.approx(j_bd.bd_quality(r1, q1, r2, q2, method),
                              abs=1e-12)
        assert bd_metrics.fix_curve([1, 3, 2, 4]) == j_bd.fix_curve(
            [1, 3, 2, 4])
    else:
        x = rng.random((1, 163, 171, 3)).astype(np.float32)
        y = np.clip(x + rng.normal(0, 0.05, x.shape), 0, 1).astype(
            np.float32)
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        np.testing.assert_allclose(msssim.ms_ssim(tx, ty).numpy(),
                                   np.asarray(j_msssim.ms_ssim(x, y)),
                                   rtol=1e-5)
        np.testing.assert_allclose(msssim.psnr(tx, ty).numpy(),
                                   np.asarray(j_msssim.psnr(x, y)),
                                   rtol=1e-5)
