"""Evaluation detector adapters for the OD-mAP branch of validation (the
port's copy of vcm_ts_tpu/eval/detector.py, native backends only).

The detector follows the configured perceptual-loss family: Faster-RCNN
losses -> the native Faster-RCNN (eval/rcnn_native.py on
pretrained/fasterrcnn_resnet50_fpn_v2_coco-dd69338a.pth, min size 1088,
max size 1920), anything else -> the native YOLOv8
(pretrained/yolov8m.npz, eval/yolo_native.py). A missing weights file
raises and names it: the port has no model-zoo fallback.

An adapter is `fn(decoded (1, H, W, C) in [0, 1]) -> {"boxes": (K, 4)
xyxy, "labels": (K,), "scores": (K,)}`, as detection_metrics consumes.
"""

from __future__ import annotations

import os

from ..train.losses import RCNN_WEIGHTS
from ..utils import weights

YOLO_WEIGHTS = "yolov8m.npz"


def build_eval_detector(cfg, device="cuda"):
    pl_model = str(getattr(cfg.SOLVER, "PL_MODEL", "resnet")).lower()
    if pl_model in ("resnet", "fpn", "faster_rcnn", "faster_rcnn_fpn",
                    "faster_rcnn_resnet"):
        path = os.path.join(weights.PRETRAINED, RCNN_WEIGHTS)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"OD-mAP eval with the Faster-RCNN detector needs {path}, "
                "which is not in the repository (set SOLVER.PL_MODEL to "
                "yolo for the native YOLOv8 detector)")
        from .rcnn_native import build_eval_adapter
        return build_eval_adapter(path, device=device)
    path = os.path.join(weights.PRETRAINED, YOLO_WEIGHTS)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"OD-mAP eval needs the YOLOv8 detector {path} (export once "
            "with tools/export_yolo_detector.py)")
    from .yolo_native import build_eval_adapter
    return build_eval_adapter(path, device=device)
