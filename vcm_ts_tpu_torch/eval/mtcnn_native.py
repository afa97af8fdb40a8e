"""MTCNN face detector: the P/R/O-Net cascade (the port's copy of
vcm_ts_tpu/eval/mtcnn_native.py).

The nets, the image pyramid and the crop resizes (OpenCV INTER_AREA, as
ops/cv_resize) run on the device. The box arithmetic between the stages
(candidate generation, Union/Min NMS, box regression, squaring) runs on
the host in numpy, as in the JAX package, with one pull per stage: every
pyramid level's P-Net output comes back in one transfer, then the R-Net
and the O-Net outputs of all crops. Semantics are facenet_pytorch's:
VALID convs, per-channel PReLU, ceil-mode max pools, the (W, H, C) flatten
order before the dense layers, (x - 127.5) / 128 input scaling, 1-indexed
boxes cropped with np.trunc and clamped to the frame. The JAX package pads
R/O-Net batches to powers of two to bound its jit specialisations; the
port runs them at their size. Weights: the JAX package's .npz with torch
names (`pnet.*`, `rnet.*`, `onet.*`), loaded with strict=True.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cv_resize import crop_resize_area, resize_area
from ..utils.device import resolve_device
from ..utils.weights import mtcnn_state_dicts

THRESHOLDS = (0.6, 0.7, 0.7)
FACTOR = 0.709
MIN_SIZE = 20


def _pool(x, k, s):
    return F.max_pool2d(x, k, s, ceil_mode=True)


def _flatten_whc(x):
    """NCHW -> (N, W*H*C) in (W, H, C) order (facenet_pytorch's dense
    input: x.permute(0, 3, 2, 1))."""
    return x.permute(0, 3, 2, 1).reshape(x.shape[0], -1)


class PNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = nn.Conv2d(3, 10, 3), nn.PReLU(10)
        self.conv2, self.prelu2 = nn.Conv2d(10, 16, 3), nn.PReLU(16)
        self.conv3, self.prelu3 = nn.Conv2d(16, 32, 3), nn.PReLU(32)
        self.conv4_1 = nn.Conv2d(32, 2, 1)
        self.conv4_2 = nn.Conv2d(32, 4, 1)

    def forward(self, x):
        x = _pool(self.prelu1(self.conv1(x)), 2, 2)
        x = self.prelu2(self.conv2(x))
        x = self.prelu3(self.conv3(x))
        return self.conv4_2(x), torch.softmax(self.conv4_1(x), dim=1)


class RNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = nn.Conv2d(3, 28, 3), nn.PReLU(28)
        self.conv2, self.prelu2 = nn.Conv2d(28, 48, 3), nn.PReLU(48)
        self.conv3, self.prelu3 = nn.Conv2d(48, 64, 2), nn.PReLU(64)
        self.dense4, self.prelu4 = nn.Linear(576, 128), nn.PReLU(128)
        self.dense5_1 = nn.Linear(128, 2)
        self.dense5_2 = nn.Linear(128, 4)

    def forward(self, x):
        x = _pool(self.prelu1(self.conv1(x)), 3, 2)
        x = _pool(self.prelu2(self.conv2(x)), 3, 2)
        x = self.prelu3(self.conv3(x))
        x = self.prelu4(self.dense4(_flatten_whc(x)))
        return self.dense5_2(x), torch.softmax(self.dense5_1(x), dim=1)


class ONet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = nn.Conv2d(3, 32, 3), nn.PReLU(32)
        self.conv2, self.prelu2 = nn.Conv2d(32, 64, 3), nn.PReLU(64)
        self.conv3, self.prelu3 = nn.Conv2d(64, 64, 3), nn.PReLU(64)
        self.conv4, self.prelu4 = nn.Conv2d(64, 128, 2), nn.PReLU(128)
        self.dense5, self.prelu5 = nn.Linear(1152, 256), nn.PReLU(256)
        self.dense6_1 = nn.Linear(256, 2)
        self.dense6_2 = nn.Linear(256, 4)
        self.dense6_3 = nn.Linear(256, 10)

    def forward(self, x):
        x = _pool(self.prelu1(self.conv1(x)), 3, 2)
        x = _pool(self.prelu2(self.conv2(x)), 3, 2)
        x = _pool(self.prelu3(self.conv3(x)), 2, 2)
        x = self.prelu4(self.conv4(x))
        x = self.prelu5(self.dense5(_flatten_whc(x)))
        return (self.dense6_2(x), self.dense6_3(x),
                torch.softmax(self.dense6_1(x), dim=1))


# --------------------------------------------------------------------------
# pipeline math (host, numpy) - Matlab-MTCNN conventions
# --------------------------------------------------------------------------

def generate_bounding_boxes(reg, probs, scale, thresh, stride=2,
                            cellsize=12):
    """P-Net dense map -> candidate boxes in original-image coordinates.
    reg (H, W, 4), probs (H, W) - one image."""
    ys, xs = np.where(probs >= thresh)
    if ys.size == 0:
        return np.zeros((0, 9), np.float32)
    score = probs[ys, xs]
    r = reg[ys, xs]
    q1 = np.stack([xs, ys], -1) * stride + 1
    q2 = np.stack([xs, ys], -1) * stride + cellsize
    return np.concatenate([q1 / scale, q2 / scale, score[:, None], r],
                          axis=1).astype(np.float32)


def nms_mtcnn(boxes, scores, thresh, mode="union"):
    """Greedy NMS with MTCNN's 'Union' (IoU) or 'Min' overlap."""
    order = np.argsort(scores)[::-1]
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        w = np.maximum(
            np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]) + 1, 0)
        h = np.maximum(
            np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest]) + 1, 0)
        inter = w * h
        if mode == "min":
            o = inter / np.minimum(area[i], area[rest])
        else:
            o = inter / (area[i] + area[rest] - inter)
        order = rest[o <= thresh]
    return np.asarray(keep, np.int64)


def bbreg(boxes, reg):
    """Apply a stage's box regression (+1 width convention)."""
    w = boxes[:, 2] - boxes[:, 0] + 1
    h = boxes[:, 3] - boxes[:, 1] + 1
    out = boxes.copy()
    out[:, 0] += reg[:, 0] * w
    out[:, 1] += reg[:, 1] * h
    out[:, 2] += reg[:, 2] * w
    out[:, 3] += reg[:, 3] * h
    return out


def rerec(boxes):
    """Square every box around its center (long side)."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    side = np.maximum(w, h)
    out = boxes.copy()
    out[:, 0] += w * 0.5 - side * 0.5
    out[:, 1] += h * 0.5 - side * 0.5
    out[:, 2] = out[:, 0] + side
    out[:, 3] = out[:, 1] + side
    return out


def crop_boxes(boxes, h: int, w: int) -> np.ndarray:
    """(K, 4) 1-indexed inclusive pixel boxes of float boxes: np.trunc,
    then clamped to [1, w] x [1, h] (facenet_pytorch pad()); a box with
    nothing visible keeps x2 < x1 or y2 < y1."""
    b = np.trunc(boxes[:, :4]).astype(np.int64)
    b[:, 0] = np.maximum(b[:, 0], 1)
    b[:, 1] = np.maximum(b[:, 1], 1)
    b[:, 2] = np.minimum(b[:, 2], w)
    b[:, 3] = np.minimum(b[:, 3], h)
    return b


def _crop_resize(img: torch.Tensor, boxes, size: int) -> torch.Tensor:
    """(K, size, size, 3) INTER_AREA crops of the visible part of each box
    (zero where nothing is visible)."""
    h, w = img.shape[:2]
    return crop_resize_area(img, crop_boxes(boxes, h, w), size)


def _norm(x):
    return (x - 127.5) * 0.0078125


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _none():
    return np.zeros((0, 4), np.float32), np.zeros((0,), np.float32)


class MTCNNNativeDetector(nn.Module):
    """The three-stage cascade on one device."""

    def __init__(self, min_size=MIN_SIZE, thresholds=THRESHOLDS,
                 factor=FACTOR, device="cuda"):
        super().__init__()
        self.min_size, self.thresholds, self.factor = (min_size, thresholds,
                                                       factor)
        self.pnet, self.rnet, self.onet = PNet(), RNet(), ONet()
        self.device = resolve_device(device)
        self.to(self.device).eval()

    @classmethod
    def load(cls, npz_path: str, device="cuda", **kw):
        det = cls(device=device, **kw)
        for net, sd in mtcnn_state_dicts(npz_path).items():
            getattr(det, net).load_state_dict(sd, strict=True)
        return det

    def scales(self, h: int, w: int) -> list:
        m = 12.0 / self.min_size
        minl = min(h, w) * m
        out = []
        while minl >= 12:
            out.append(m)
            m *= self.factor
            minl *= self.factor
        return out

    @torch.no_grad()
    def detect(self, frame_rgb_uint8):
        """Returns (boxes xyxy float (K, 4), scores (K,)), the
        facenet_pytorch MTCNN.detect contract."""
        if isinstance(frame_rgb_uint8, torch.Tensor):
            img = frame_rgb_uint8.to(self.device).float()
        else:
            img = torch.from_numpy(np.ascontiguousarray(
                frame_rgb_uint8)).to(self.device).float()
        h, w = img.shape[:2]
        t1, t2, t3 = self.thresholds

        # stage 1: P-Net over the pyramid, one pull for all levels
        scales = self.scales(h, w)
        maps, shapes = [], []
        for scale in scales:
            hs, ws = int(np.ceil(h * scale)), int(np.ceil(w * scale))
            level = _norm(resize_area(img, hs, ws))[None]
            reg, probs = self.pnet(_nchw(level))
            maps.append(torch.cat([reg[0], probs[0, 1:]], 0).flatten())
            shapes.append(reg.shape[2:])
        flat = torch.cat(maps).cpu().numpy() if maps else np.zeros(0)
        total, pos = [], 0
        for scale, (ph, pw) in zip(scales, shapes):
            m = flat[pos:pos + 5 * ph * pw].reshape(5, ph, pw)
            pos += 5 * ph * pw
            boxes = generate_bounding_boxes(m[:4].transpose(1, 2, 0), m[4],
                                            scale, t1)
            if boxes.shape[0]:
                keep = nms_mtcnn(boxes[:, :4], boxes[:, 4], 0.5)
                total.append(boxes[keep])
        if not total:
            return _none()
        boxes = np.concatenate(total, 0)
        keep = nms_mtcnn(boxes[:, :4], boxes[:, 4], 0.7)
        boxes = boxes[keep]
        # stage-1 regression uses the raw extent (no +1), unlike bbreg in
        # stages 2/3 (facenet_pytorch detect_face qq1..qq4)
        regw = boxes[:, 2] - boxes[:, 0]
        regh = boxes[:, 3] - boxes[:, 1]
        q = boxes[:, :5].copy()
        q[:, 0] += boxes[:, 5] * regw
        q[:, 1] += boxes[:, 6] * regh
        q[:, 2] += boxes[:, 7] * regw
        q[:, 3] += boxes[:, 8] * regh
        boxes = rerec(q)

        # stage 2: R-Net on 24x24 crops, one pull
        crops = _norm(_crop_resize(img, boxes, 24))
        reg, probs = self.rnet(_nchw(crops))
        out = torch.cat([reg, probs], 1).cpu().numpy()
        reg, score = out[:, :4], out[:, 5]
        sel = score >= t2
        boxes, reg, score = boxes[sel], reg[sel], score[sel]
        if not boxes.shape[0]:
            return _none()
        keep = nms_mtcnn(boxes[:, :4], score, 0.7)
        boxes, reg, score = boxes[keep], reg[keep], score[keep]
        boxes = rerec(bbreg(np.concatenate(
            [boxes[:, :4], score[:, None]], 1), reg))

        # stage 3: O-Net on 48x48 crops, one pull
        crops = _norm(_crop_resize(img, boxes, 48))
        reg, _lmk, probs = self.onet(_nchw(crops))
        out = torch.cat([reg, probs], 1).cpu().numpy()
        reg, score = out[:, :4], out[:, 5]
        sel = score >= t3
        boxes, reg, score = boxes[sel], reg[sel], score[sel]
        if not boxes.shape[0]:
            return _none()
        boxes = bbreg(np.concatenate([boxes[:, :4], score[:, None]], 1), reg)
        keep = nms_mtcnn(boxes[:, :4], score, 0.7, mode="min")
        boxes, score = boxes[keep], score[keep]
        out = boxes[:, :4].copy()
        out[:, [0, 2]] = out[:, [0, 2]].clip(0, w)
        out[:, [1, 3]] = out[:, [1, 3]].clip(0, h)
        return out, score.astype(np.float32)


def build_face_adapter(npz_path: str, device="cuda"):
    """vcm_pipeline.build_detector contract: frame -> (boxes, scores)."""
    return MTCNNNativeDetector.load(npz_path, device=device).detect
