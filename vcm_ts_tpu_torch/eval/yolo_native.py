"""YOLOv8 detector: backbone + neck + v8 Detect head, DFL box decode,
letterbox, greedy NMS (the port's copy of vcm_ts_tpu/eval/yolo_native.py).

The network and the letterbox run on the device; one pull per frame
brings the decoded boxes and scores to the host, where the confidence
filter, class-aware NMS and the undoing of the letterbox run in numpy as
in the JAX package. Weights: the JAX package's torch-free .npz
(tools/export_yolo_detector.py, tools/train_plate_detector.py), whose
names are ultralytics state-dict names, so the port loads them with
strict=True ("model.22." is the head; its constant `dfl.` kernel is not a
parameter).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..codec.bitstream import get_padding_size
from ..ops.cv_resize import resize_linear_u8
from ..train.yolo_v8 import ConvBnSiLU, YOLOv8Backbone
from ..utils.device import resolve_device
from ..utils.weights import yolo_state_dicts

STRIDES = (8, 16, 32)


class YOLOv8Detect(nn.Module):
    """v8 Detect head ("model.22"): per scale a box branch (cv2.i) with
    4*reg_max DFL logits and a class branch (cv3.i)."""

    def __init__(self, ch, nc: int = 80, reg_max: int = 16):
        super().__init__()
        self.nc, self.reg_max = nc, reg_max
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(nn.Sequential(
            ConvBnSiLU(c, c2, 3), ConvBnSiLU(c2, c2, 3),
            nn.Conv2d(c2, 4 * reg_max, 1)) for c in ch)
        self.cv3 = nn.ModuleList(nn.Sequential(
            ConvBnSiLU(c, c3, 3), ConvBnSiLU(c3, c3, 3),
            nn.Conv2d(c3, nc, 1)) for c in ch)

    def forward(self, feats):
        return [(b(f), c(f)) for f, b, c in zip(feats, self.cv2, self.cv3)]


def decode_detections(outs, reg_max: int = 16, strides=STRIDES):
    """(box, cls) NCHW maps per scale -> (boxes xyxy (N, M, 4) in input
    pixels, scores (N, M, nc) sigmoid)."""
    boxes_all, scores_all = [], []
    for (box, cls), s in zip(outs, strides):
        n, _, h, w = box.shape
        bins = torch.arange(reg_max, dtype=box.dtype, device=box.device)
        d = torch.softmax(box.permute(0, 2, 3, 1).reshape(
            n, h, w, 4, reg_max), dim=-1) @ bins
        cx = (torch.arange(w, dtype=box.dtype, device=box.device)
              + 0.5)[None, None, :]
        cy = (torch.arange(h, dtype=box.dtype, device=box.device)
              + 0.5)[None, :, None]
        x1 = (cx - d[..., 0]) * s
        y1 = (cy - d[..., 1]) * s
        x2 = (cx + d[..., 2]) * s
        y2 = (cy + d[..., 3]) * s
        boxes_all.append(
            torch.stack([x1, y1, x2, y2], dim=-1).reshape(n, h * w, 4))
        scores_all.append(torch.sigmoid(cls).permute(0, 2, 3, 1).reshape(
            n, h * w, cls.shape[1]))
    return torch.cat(boxes_all, 1), torch.cat(scores_all, 1)


def letterbox(img: torch.Tensor, imgsz: int = 640, pad_value: int = 114):
    """Aspect-preserving INTER_LINEAR resize of an (H, W, 3) uint8 frame on
    the device into an (imgsz, imgsz) canvas padded with 114 (the
    ultralytics LetterBox convention). Returns (canvas (imgsz, imgsz, 3)
    f32 in [0, 1], scale r, (left, top) pad)."""
    h, w = img.shape[:2]
    r = min(imgsz / h, imgsz / w)
    nw, nh = round(w * r), round(h * r)
    dw, dh = (imgsz - nw) / 2, (imgsz - nh) / 2
    resized = resize_linear_u8(img, nh, nw) if (nw, nh) != (w, h) else img
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    canvas = torch.full((nh + top + bottom, nw + left + right, 3), pad_value,
                        dtype=torch.uint8, device=img.device)
    canvas[top:top + nh, left:left + nw] = resized
    return canvas.float() / 255.0, r, (left, top)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thres: float = 0.7,
        max_det: int = 300) -> np.ndarray:
    """Greedy IoU NMS; returns kept indices sorted by descending score."""
    order = np.argsort(scores)[::-1]
    x1, y1, x2, y2 = boxes.T
    areas = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    keep = []
    while order.size and len(keep) < max_det:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-9)
        order = rest[iou <= iou_thres]
    return np.asarray(keep, np.int64)


def _frame_tensor(frame, device) -> torch.Tensor:
    """An (H, W, 3) uint8 frame (numpy or tensor) on `device`."""
    if isinstance(frame, torch.Tensor):
        return frame.to(device)
    return torch.from_numpy(np.ascontiguousarray(frame)).to(device)


class YOLOv8NativeDetector(nn.Module):
    """Backbone ("model.N") + head ("model.22") on one device."""

    def __init__(self, nc: int = 80, width: float = 0.75,
                 depth: float = 0.67, max_channels: int = 768,
                 reg_max: int = 16, imgsz: int = 640, device="cuda"):
        super().__init__()
        self.nc, self.reg_max, self.imgsz = nc, reg_max, imgsz
        self.backbone = YOLOv8Backbone(width, depth, max_channels)
        self.head = YOLOv8Detect(self.backbone.out_channels, nc, reg_max)
        self.device = resolve_device(device)
        self.to(self.device).eval()

    @classmethod
    def load(cls, npz_path: str, imgsz: int | None = None, device="cuda"):
        """Load a tools/export_yolo_detector.py or
        tools/train_plate_detector.py .npz. imgsz: the argument, else the
        file's meta record, else 640."""
        meta, bb_sd, head_sd = yolo_state_dicts(npz_path)
        if imgsz is None:
            imgsz = int(meta.get("imgsz", 640))
        det = cls(nc=meta["nc"], width=meta["width"], depth=meta["depth"],
                  max_channels=meta["max_channels"], reg_max=meta["reg_max"],
                  imgsz=imgsz, device=device)
        det.backbone.load_state_dict(bb_sd, strict=True)
        det.head.load_state_dict(head_sd, strict=True)
        return det

    @torch.no_grad()
    def raw(self, x_nhwc: torch.Tensor):
        """(boxes, scores) of an (N, H, W, 3) f32 batch in input pixels,
        on the device."""
        taps = self.backbone(x_nhwc.to(self.device).permute(0, 3, 1, 2))
        outs = self.head([taps["3_deep"], taps["4_deep"], taps["5_deep"]])
        return decode_detections(outs, self.reg_max)

    def _pull(self, canvas):
        boxes, scores = self.raw(canvas[None])
        both = torch.cat([boxes[0], scores[0]], -1).cpu().numpy()
        return both[:, :4].astype(np.float32), both[:, 4:].astype(np.float32)

    def _filter(self, boxes, scores, conf, iou, max_det, span):
        labels = scores.argmax(-1)
        best = scores.max(-1)
        sel = best >= conf
        boxes, best, labels = boxes[sel], best[sel], labels[sel]
        if boxes.shape[0]:
            # class-aware NMS: offset boxes per class; decoded boxes are
            # unclipped, so the step must clear their full span
            step = span + 2 * self.reg_max * max(STRIDES)
            off = labels[:, None].astype(np.float32) * step
            keep = nms(boxes + off, best, iou, max_det)
            boxes, best, labels = boxes[keep], best[keep], labels[keep]
        return boxes, best, labels

    def detect(self, frame_rgb_uint8, conf: float = 0.25, iou: float = 0.7,
               max_det: int = 300):
        """Letterbox -> forward -> confidence filter -> class-aware NMS ->
        boxes in frame pixels. Returns (boxes xyxy (K, 4), scores (K,),
        labels (K,))."""
        h0, w0 = frame_rgb_uint8.shape[:2]
        canvas, r, (dw, dh) = letterbox(
            _frame_tensor(frame_rgb_uint8, self.device), self.imgsz)
        boxes, scores = self._pull(canvas)
        boxes, best, labels = self._filter(boxes, scores, conf, iou, max_det,
                                           self.imgsz)
        boxes[:, [0, 2]] = (boxes[:, [0, 2]] - dw) / r
        boxes[:, [1, 3]] = (boxes[:, [1, 3]] - dh) / r
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w0)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h0)
        return boxes, best, labels

    def detect_padded(self, frame_rgb_uint8, conf: float = 0.25,
                      iou: float = 0.7, max_det: int = 300):
        """Detection at the frame's own size, padded to a multiple of 32
        (no letterbox rescale)."""
        h0, w0 = frame_rgb_uint8.shape[:2]
        pl, pr, pt, pb = get_padding_size(h0, w0, p=32)
        frame = _frame_tensor(frame_rgb_uint8, self.device).float() / 255.0
        canvas = torch.nn.functional.pad(frame, (0, 0, pl, pr, pt, pb))
        boxes, scores = self._pull(canvas)
        boxes, best, labels = self._filter(
            boxes, scores, conf, iou, max_det,
            float(max(canvas.shape[:2])))
        boxes[:, [0, 2]] = (boxes[:, [0, 2]] - pl).clip(0, w0)
        boxes[:, [1, 3]] = (boxes[:, [1, 3]] - pt).clip(0, h0)
        return boxes, best, labels


def build_lp_adapter(npz_path: str, conf: float = 0.25, device="cuda"):
    """vcm_pipeline.build_detector contract: frame -> (boxes, scores)."""
    det = YOLOv8NativeDetector.load(npz_path, device=device)

    def adapter(frame):
        boxes, scores, _ = det.detect(frame, conf=conf)
        return boxes, scores

    return adapter


def build_eval_adapter(npz_path: str, conf: float = 0.25, device="cuda"):
    """eval/detector.py contract: decoded [0,1] (1, H, W, C) -> dict of
    boxes, labels (raw class ids) and scores."""
    det = YOLOv8NativeDetector.load(npz_path, device=device)

    def adapter(decoded):
        if isinstance(decoded, torch.Tensor):
            frame = torch.round(decoded[0] * 255).clamp(0, 255).to(
                torch.uint8)
        else:
            frame = np.rint(np.asarray(decoded)[0] * 255).clip(
                0, 255).astype(np.uint8)
        boxes, scores, labels = det.detect(frame, conf=conf)
        return {"boxes": boxes, "labels": labels.astype(np.int64),
                "scores": scores}

    return adapter
