"""License-plate OCR: the CRNN-CTC recognizer (the port's copy of the
inference half of vcm_ts_tpu/eval/ocr_native.py).

`PlateRecognizer`: a conv stack (GroupNorm(8), so inference is stateless)
that collapses 32 x W gray crops to a W/4-step sequence, two BiLSTM(96)
layers and a CTC head over blank + [0-9A-Z]. `PlateOCRNative` crops the
boxes from a frame, converts them to gray, resizes them to height 32
(OpenCV INTER_CUBIC, ops/cv_resize) and right-pads them into width
buckets on the device, then greedy-CTC-decodes on the host (one pull per
bucket).

The shipped weights (pretrained/plate_ocr.npz) are a flax tree, mapped
onto this module by utils/weights.ocr_state_dict (each BiLSTM is one
bidirectional nn.LSTM). The CTC training path is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cv_resize import resize_cubic_u8
from ..utils.device import resolve_device
from ..utils.weights import ocr_state_dict

CHARSET = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
NUM_CLASSES = len(CHARSET) + 1  # + blank at index 0
IMG_H = 32
WIDTH_BUCKETS = (64, 96, 128, 160)
_STAGES = ((64, (2, 2)), (128, (2, 2)), (192, None), (192, (2, 1)),
           (192, (2, 1)))


def encode_text(text: str, max_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Text -> (labels, label_paddings) row for a CTC loss."""
    ids = [CHARSET.index(c) + 1 for c in text]
    labels = np.zeros((max_len,), np.int32)
    pad = np.ones((max_len,), np.float32)
    labels[: len(ids)] = ids
    pad[: len(ids)] = 0.0
    return labels, pad


def ctc_greedy_decode(logits) -> list[str]:
    """Greedy CTC decode of (B, T, NUM_CLASSES) logits: collapse repeats,
    drop blanks."""
    best = np.asarray(logits).argmax(axis=-1)
    out = []
    for row in best:
        prev = 0
        chars = []
        for k in row:
            if k != prev and k != 0:
                chars.append(CHARSET[k - 1])
            prev = k
        out.append("".join(chars))
    return out


class PlateRecognizer(nn.Module):
    """(B, 1, 32, W) gray in [-1, 1] -> (B, W/4, NUM_CLASSES) logits."""

    def __init__(self):
        super().__init__()
        cin = 1
        for i, (feat, _) in enumerate(_STAGES):
            setattr(self, f"conv{i}", nn.Conv2d(cin, feat, 3, padding=1))
            setattr(self, f"gn{i}", nn.GroupNorm(8, feat, eps=1e-6))
            cin = feat
        self.lstm0 = nn.LSTM(2 * cin, 96, batch_first=True,
                             bidirectional=True)
        self.lstm1 = nn.LSTM(192, 96, batch_first=True, bidirectional=True)
        self.head = nn.Linear(192, NUM_CLASSES)

    def forward(self, x):
        for i, (_, pool) in enumerate(_STAGES):
            x = F.relu(getattr(self, f"gn{i}")(getattr(self, f"conv{i}")(x)))
            if pool is not None:
                x = F.max_pool2d(x, pool, pool)
        b, c, h, t = x.shape  # h == 2 for IMG_H == 32
        x = x.permute(0, 3, 2, 1).reshape(b, t, h * c)
        x = self.lstm0(x)[0]
        x = self.lstm1(x)[0]
        return self.head(x)


def _to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """float [0,1] (H, W, 3) or (H, W) -> uint8 gray, ITU-R 601."""
    a = rgb.float()
    if a.dim() == 3:
        w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                         device=a.device)
        a = a @ w
    return torch.round(a * 255.0).clamp(0, 255).to(torch.uint8)


def preprocess_crop(gray: torch.Tensor) -> torch.Tensor:
    """(h, w) uint8 gray crop -> (32, bucket_w) f32 in [-1, 1], aspect
    preserved, right-padded with 0 (mid-gray) into its width bucket."""
    h, w = gray.shape[:2]
    new_w = max(8, int(round(w * (IMG_H / max(h, 1)))))
    new_w = min(new_w, WIDTH_BUCKETS[-1])
    img = resize_cubic_u8(gray[:, :, None], IMG_H, new_w)[:, :, 0]
    img = img.float() / 127.5 - 1.0
    bucket = next(b for b in WIDTH_BUCKETS if b >= new_w)
    return F.pad(img, (0, bucket - new_w))


class PlateOCRNative:
    """Recognize plate text in frame crops: float [0,1] RGB frame + (N, 4)
    xyxy boxes -> list of A-Z0-9 strings."""

    def __init__(self, model: PlateRecognizer, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    @classmethod
    def load(cls, npz_path: str, device="cuda") -> "PlateOCRNative":
        model = PlateRecognizer()
        model.load_state_dict(ocr_state_dict(npz_path, CHARSET), strict=True)
        return cls(model, device)

    @torch.no_grad()
    def logits(self, batch: torch.Tensor) -> torch.Tensor:
        """(B, 32, W) preprocessed crops -> (B, W/4, NUM_CLASSES)."""
        return self.model(batch.to(self.device)[:, None])

    def recognize_crops(self, crops: list) -> list[str]:
        """uint8 gray crops (tensors) -> decoded strings, one batch per
        width bucket."""
        if not crops:
            return []
        pre = [preprocess_crop(c) for c in crops]
        out = [""] * len(crops)
        by_w: dict[int, list[int]] = {}
        for i, p in enumerate(pre):
            by_w.setdefault(p.shape[1], []).append(i)
        for idxs in by_w.values():
            logits = self.logits(torch.stack([pre[i] for i in idxs]))
            for i, text in zip(idxs, ctc_greedy_decode(
                    logits.cpu().numpy())):
                out[i] = text
        return out

    def __call__(self, rgb, boxes) -> list[str]:
        if not isinstance(rgb, torch.Tensor):
            rgb = torch.from_numpy(np.ascontiguousarray(rgb, np.float32))
        rgb = rgb.to(self.device)
        h, w = rgb.shape[:2]
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        out = [""] * len(boxes)
        crops, idxs = [], []
        for i, (x1, y1, x2, y2) in enumerate(boxes):
            x1, y1 = max(int(x1), 0), max(int(y1), 0)
            x2, y2 = min(int(np.ceil(x2)), w), min(int(np.ceil(y2)), h)
            if x2 <= x1 + 1 or y2 <= y1 + 1:
                continue  # degenerate box: no pixels to read
            crops.append(_to_gray(rgb[y1:y2, x1:x2]))
            idxs.append(i)
        for i, text in zip(idxs, self.recognize_crops(crops)):
            out[i] = text
        return out
