"""PyTorch port, the Faster-RCNN eval detector (eval/rcnn_native.py) and
the Faster-RCNN perceptual losses' checkpoint path against the JAX package
on the CPU.

The checkpoint: a torchvision fasterrcnn_resnet50_fpn_v2-layout state
dict written with torch.save, which both stacks load (the JAX detector's
load_pth, the port's load_pth strict): the backbone is the perceptual
loss's seeded flax tree carried into the port
(tests/test_torch_perceptual.py), the heads are
tests/test_rcnn_native.py's `_fake_v2_sd` (5 classes) with the box head's
convs, its linear layer and the class scores scaled to unit gain (1 /
sqrt(fan in)): under `_fake_v2_sd`'s own scale the box head's activations
reach about 1e6 and every softmax saturates to 0 or 1, so the scores tie
and NMS orders ties by float noise. The detector runs at 50x70 with min
64 / max 96 (a 64x90 resize, padded to 64x96).

Tolerances: the box math (anchors, decode, clip, level mapping, NMS
indices, RoIAlign) equal or within 1e-6; the FPN levels, the RPN's logits
and deltas and the box head's scores and deltas within 1e-4 of each
output's largest magnitude (XLA's and oneDNN's convs sum in other
orders); detect(): labels equal, boxes within 1e-3 px, scores rtol 1e-4.
In detect() the JAX side's cv2.resize is the port's resize_linear_u8:
the port's INTER_LINEAR differs from cv2's SIMD path by one level at a
row's last pixels (69 of 17280 values here; tests/test_torch_imageio.py
holds the resize to cv2), which the random network would carry past the
tolerances; the rest of the pipeline is held from the same pixels.
The ResNet perceptual loss (value f32, gradient float64 on both sides,
as tests/test_torch_perceptual.py holds the FPN and YOLO losses) is here
for the time budget.
"""

from __future__ import annotations

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rcnn_native import _fake_v2_sd
from tests.test_torch_perceptual import (RESNET_TAPS,  # noqa: F401
                                         _frames, check_gradient_f64, nets)
from tests.test_torch_warp_twopass import one_torch_thread  # noqa: F401
from tests.torch_port_util import nchw, nhwc
from vcm_ts_tpu.eval import rcnn_native as jrn
from vcm_ts_tpu_torch import benchmark_plot as tbp
from vcm_ts_tpu_torch.eval import detector as t_detector
from vcm_ts_tpu_torch.eval import rcnn_native as rn
from vcm_ts_tpu_torch.ops.cv_resize import resize_linear_u8
from vcm_ts_tpu_torch.train import losses as L
from vcm_ts_tpu_torch.utils import weights

MIN, MAX = 64, 96


def _unit_gain_heads():
    sd = _fake_v2_sd()
    for k, v in sd.items():
        if k.startswith(("roi_heads.box_head.", "roi_heads.box_predictor."
                         "cls_score.")) and k.endswith("weight") \
                and v.dim() > 1:
            sd[k] = v / float(np.sqrt(v[0].numel()))
    return sd


@pytest.fixture(scope="module")
def pth(nets, tmp_path_factory):
    """The checkpoint both stacks load (see the module docstring)."""
    sd = {"backbone." + k: v.clone()
          for k, v in nets["fpn"][2].state_dict().items()}
    sd.update(_unit_gain_heads())
    path = str(tmp_path_factory.mktemp("rcnn") / "rcnn.pth")
    torch.save(sd, path)
    return path


@pytest.fixture(scope="module")
def dets(pth):
    """(JAX detector, port detector) from the checkpoint."""
    orig = jrn.FasterRCNNNativeDetector.init

    def traced_init(self, rng=None):
        # the eager flax init only gives the tree its shapes (load_pth then
        # reads every leaf from the file): trace it instead
        shapes = jax.eval_shape(lambda: orig(self).params)
        self.params = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), shapes)
        return self

    jrn.FasterRCNNNativeDetector.init = traced_init
    try:
        jdet = jrn.FasterRCNNNativeDetector.load_pth(pth, min_size=MIN,
                                                     max_size=MAX)
    finally:
        jrn.FasterRCNNNativeDetector.init = orig
    return jdet, rn.FasterRCNNNativeDetector.load_pth(
        pth, device="cpu", min_size=MIN, max_size=MAX)


def _frame(seed=32, h=50, w=70):
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(
        np.uint8)


def _close_to_max(got, want, rel, name=""):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.max(np.abs(want))),
                               err_msg=name)


@pytest.mark.parametrize("what", ["anchors", "decode", "clip", "levels",
                                  "nms", "roi_align"])
def test_box_math_matches_jax(what):
    rng = np.random.default_rng(33)
    if what == "anchors":
        for size in rn.ANCHOR_SIZES:
            np.testing.assert_array_equal(rn.cell_anchors(size),
                                          jrn.cell_anchors(size))
        for h, w, s, size in ((16, 24, 4, 32), (3, 5, 64, 512),
                              (34, 60, 32, 256)):
            np.testing.assert_array_equal(rn.level_anchors(h, w, s, size),
                                          jrn.level_anchors(h, w, s, size))
    elif what == "decode":
        anchors = rn.level_anchors(4, 6, 16, 128)
        deltas = rng.normal(0, 1.5, anchors.shape).astype(np.float32)
        deltas[:3, 2:] = 9.0  # past BBOX_XFORM_CLIP
        for wts in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
            np.testing.assert_allclose(
                rn.decode_boxes(deltas, anchors, wts),
                jrn.decode_boxes(deltas, anchors, wts), rtol=1e-6, atol=0)
    elif what == "clip":
        boxes = rng.normal(40, 60, (50, 4)).astype(np.float32)
        np.testing.assert_array_equal(rn.clip_boxes(boxes, 64, 90),
                                      jrn.clip_boxes(boxes, 64, 90))
    elif what == "levels":
        xy = rng.uniform(0, 500, (200, 2)).astype(np.float32)
        side = np.exp(rng.uniform(0, 7.5, (200, 2))).astype(np.float32)
        rois = np.concatenate([xy, xy + side], 1)
        np.testing.assert_array_equal(rn.map_levels(rois),
                                      jrn.map_levels(rois))
        assert set(rn.map_levels(rois)) == {0, 1, 2, 3}
    elif what == "nms":
        xy = rng.uniform(0, 20, (300, 2)).astype(np.float32)
        boxes = np.concatenate(
            [xy, xy + rng.uniform(10, 20, (300, 2)).astype(np.float32)], 1)
        scores = rng.random(300).astype(np.float32)
        idxs = rng.integers(0, 4, 300)
        for thr in (0.5, 0.7):
            got = rn.batched_nms(boxes, scores, idxs, thr)
            np.testing.assert_array_equal(
                got, jrn.batched_nms(boxes, scores, idxs, thr))
            assert 0 < len(got) < 300
        assert rn.batched_nms(boxes[:0], scores[:0], idxs[:0], 0.5).shape \
            == (0,)
    else:
        feat = rng.normal(size=(12, 16, 5)).astype(np.float32)
        rois = np.array([[4., 8., 40., 36.], [-8., -8., 20., 20.],
                         [0., 0., 63., 47.], [10., 10., 10.5, 10.2],
                         [60., 40., 90., 70.]], np.float32)
        for scale in (0.25, 0.125):
            got = rn.roi_align(torch.from_numpy(feat).permute(2, 0, 1),
                               rois, scale)
            want = np.asarray(jrn.roi_align(feat, rois, scale))
            assert got.shape == (5, 5, 7, 7)
            np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                       want, rtol=0, atol=1e-6)


def test_backbone_rpn_and_box_head_match_jax(dets):
    """The FPN levels and the RPN's outputs on the preprocessed frame, and
    the box head's softmax scores and deltas on the same crops."""
    jdet, det = dets
    x, (nh, nw) = det._preprocess(_frame())
    assert (nh, nw) == (64, 90) and tuple(x.shape) == (1, 3, 64, 96)
    levels, rpn = det.forward_backbone(x)
    p = jdet.params
    jlevels, jrpn = jdet._backbone_fwd()(p["body"], p["fpn"], p["rpn"],
                                         jnp.asarray(nhwc(x)))
    for k, (a, b) in enumerate(zip(levels, jlevels)):
        _close_to_max(nhwc(a), np.asarray(b), 1e-4, f"level {k}")
    for k, ((lo, de), (jlo, jde)) in enumerate(zip(rpn, jrpn)):
        _close_to_max(nhwc(lo), np.asarray(jlo), 1e-4, f"rpn logits {k}")
        _close_to_max(nhwc(de), np.asarray(jde), 1e-4, f"rpn deltas {k}")
    crops = np.random.default_rng(34).normal(
        size=(6, 7, 7, 256)).astype(np.float32)
    with torch.no_grad():
        scores, deltas = det.roi_heads.box_predictor(
            det.roi_heads.box_head(nchw(crops).contiguous()))
    jscores, jdeltas = jdet._box_fwd()(p["box"], jnp.asarray(crops))
    _close_to_max(scores.numpy(), np.asarray(jscores), 1e-4, "box scores")
    _close_to_max(deltas.numpy(), np.asarray(jdeltas), 1e-4, "box deltas")
    # unit gain: the scores spread, no softmax saturates
    assert 0.01 < float(scores.max()) < 0.99


def test_detect_matches_jax(dets, monkeypatch):
    """detect() on a 50x70 frame: the same detections (see the module
    docstring for the shared resize), two pulls."""
    jdet, det = dets
    frame = _frame()
    monkeypatch.setattr(cv2, "resize", lambda img, size, interpolation:
                        resize_linear_u8(torch.from_numpy(img), size[1],
                                         size[0]).numpy())
    want = jdet.detect(frame)
    pulls = det.pulls
    got = det.detect(frame)
    assert det.pulls - pulls == 2
    assert len(want["labels"]) > 10
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4)
    assert got["labels"].min() >= 1 and got["labels"].max() < 5
    assert (got["boxes"][:, [0, 2]] <= 70).all()
    assert (got["boxes"][:, [1, 3]] <= 50).all()


def test_carried_weights_and_loading(dets, pth, tmp_path, monkeypatch):
    """utils/weights.rcnn_state_dict_from_flax maps the JAX detector's
    tree onto torchvision's names (the port loads it strict and holds the
    file's tensors); introspect rejects the v1 layout; the eval detector
    and benchmark_plot's rcnn branch raise naming the missing .pth, and run
    from one: build_eval_adapter (min / max size 1088 / 1920, run at 64 /
    96 here for the CPU's time) on a decoded frame, numpy or tensor, the
    rcnn branch with labels offset by labels_start_index."""
    jdet, det = dets
    carried = weights.rcnn_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jdet.params))
    fresh = rn.FasterRCNNNativeDetector(num_classes=5, device="cpu")
    fresh.load_state_dict(carried, strict=True)
    for k, v in det.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0,
                                   msg=k)

    assert rn.FasterRCNNNativeDetector.introspect(_fake_v2_sd()) == dict(
        num_classes=5, rpn_depth=2, rpn_norm=False, box_convs=4,
        box_fc=1024)
    with pytest.raises(RuntimeError, match="v1 TwoMLPHead"):
        rn.FasterRCNNNativeDetector.introspect(
            {"roi_heads.box_head.fc6.weight": torch.zeros(1024, 12544)})

    class Cfg:
        class SOLVER:
            PL_MODEL = "fpn"

    monkeypatch.setattr(weights, "PRETRAINED", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=L.RCNN_WEIGHTS):
        t_detector.build_eval_detector(Cfg, device="cpu")
    with pytest.raises(FileNotFoundError, match=L.RCNN_WEIGHTS):
        tbp.build_rcnn("cpu")
    os.symlink(pth, str(tmp_path / L.RCNN_WEIGHTS))
    adapter = t_detector.build_eval_detector(Cfg, device="cpu")
    assert adapter.detector.cfg["min_size"] == 1088
    assert adapter.detector.cfg["max_size"] == 1920
    adapter.detector.cfg.update(min_size=MIN, max_size=MAX,
                                rpn_post_nms=64)  # the CPU's time
    decoded = _frame(35, 24, 40).astype(np.float32)[None] / 255.0
    out = adapter(decoded)
    assert set(out) == {"boxes", "labels", "scores"}
    same = adapter(torch.from_numpy(decoded))
    np.testing.assert_array_equal(same["labels"], out["labels"])

    det_fn = tbp.build_rcnn("cpu", weights=pth)
    assert det_fn.detector.cfg["min_size"] == 800
    det_fn.detector.cfg.update(min_size=MIN, max_size=MAX, rpn_post_nms=64)
    got = det_fn(_frame().astype(np.float32) / 255.0, 3)
    want = det_fn.detector.detect(_frame())
    np.testing.assert_array_equal(got["labels"], want["labels"] + 3)
    np.testing.assert_array_equal(got["boxes"], want["boxes"])


def test_resnet_loss_and_gradient_match_jax(nets):
    """The ResNet perceptual loss (the Faster-RCNN body's five taps):
    value (f32, 2x60x60) rtol 1e-4, d loss / d decoded in float64 on both
    sides within 1e-3 of the largest (see
    tests/test_torch_perceptual.py::test_loss_and_gradient_match_jax,
    which holds the FPN and YOLO losses so)."""
    jmodel, params, port = nets["resnet"]
    decoded, target = _frames(3)

    def jloss(d, tg):
        return jmodel.apply(params, d, tg, feature_layers=RESNET_TAPS)

    def loss(model, d, tg):
        return model(d, tg)

    jvals = jax.jit(jloss)(jnp.asarray(decoded), jnp.asarray(target))
    with torch.no_grad():
        vals = port(nchw(decoded).contiguous(), nchw(target).contiguous())
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-4)
    check_gradient_f64(jloss, loss, port, decoded[:1], target[:1], "resnet")
