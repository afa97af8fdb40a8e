"""Evaluation detector adapters for the OD-mAP branch of validation (the
port's copy of vcm_ts_tpu/eval/detector.py, native backends only).

The detector follows the configured perceptual-loss family: Faster-RCNN
losses -> Faster-RCNN (not ported yet: it needs
pretrained/fasterrcnn_resnet50_fpn_v2_coco-dd69338a.pth, which the
repository does not ship), anything else -> the native YOLOv8
(pretrained/yolov8m.npz, eval/yolo_native.py). A missing weights file
raises: the port has no model-zoo fallback.

An adapter is `fn(decoded (1, H, W, C) in [0, 1]) -> {"boxes": (K, 4)
xyxy, "labels": (K,), "scores": (K,)}`, as detection_metrics consumes.
"""

from __future__ import annotations

import os

from ..utils import weights

RCNN_WEIGHTS = "fasterrcnn_resnet50_fpn_v2_coco-dd69338a.pth"
YOLO_WEIGHTS = "yolov8m.npz"


def build_eval_detector(cfg, device="cuda"):
    pl_model = str(getattr(cfg.SOLVER, "PL_MODEL", "resnet")).lower()
    if pl_model in ("resnet", "fpn", "faster_rcnn", "faster_rcnn_fpn",
                    "faster_rcnn_resnet"):
        raise NotImplementedError(
            f"OD-mAP eval with the Faster-RCNN detector needs "
            f"pretrained/{RCNN_WEIGHTS}, which is not in the repository; "
            "the port's Faster-RCNN waits for it (set SOLVER.PL_MODEL to "
            "yolo for the native YOLOv8 detector)")
    path = os.path.join(weights.PRETRAINED, YOLO_WEIGHTS)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"OD-mAP eval needs the YOLOv8 detector {path} (export once "
            "with tools/export_yolo_detector.py)")
    from .yolo_native import build_eval_adapter
    return build_eval_adapter(path, device=device)
