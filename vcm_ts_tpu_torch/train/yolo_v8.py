"""YOLOv8 backbone and neck, and the YOLO perceptual loss (the port's copy
of vcm_ts_tpu/train/yolo_v8.py:34-217).

Conv = conv (no bias) + frozen BatchNorm + SiLU; C2f with split/dense
bottlenecks; SPPF; nearest upsample + concat neck. Children carry the
ultralytics state-dict names ("0".."21", cv1/cv2/m.N/conv/bn), so weights
exported from ultralytics load with strict=True. NCHW. The convs go
through ops/rowwise.conv2d (the perceptual loss differentiates through
them; see train/losses.py).

Weights come from the torch-free .npz (tools/export_yolo_detector.py)
through utils/weights.yolo_state_dicts, not from the .pt: unpickling the
.pt needs ultralytics' classes.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..codec.bitstream import get_padding_size
from ..ops.layers import Conv2d
from ..utils.weights import yolo_state_dicts
from .losses import FrozenBatchNorm, jclip01


class ConvBnSiLU(nn.Module):
    """ultralytics Conv: conv(bias=False) + BN + SiLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride, kernel // 2,
                           bias=False)
        self.bn = FrozenBatchNorm(cout, eps=1e-3)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBnSiLU(c, c, 3)
        self.cv2 = ConvBnSiLU(c, c, 3)
        self.shortcut = shortcut

    def forward(self, x):
        out = self.cv2(self.cv1(x))
        return x + out if self.shortcut else out


class C2f(nn.Module):
    def __init__(self, cin: int, cout: int, n: int = 1,
                 shortcut: bool = False):
        super().__init__()
        c_ = cout // 2
        self.cv1 = ConvBnSiLU(cin, 2 * c_, 1)
        self.m = nn.ModuleList(Bottleneck(c_, shortcut) for _ in range(n))
        self.cv2 = ConvBnSiLU((2 + n) * c_, cout, 1)

    def forward(self, x):
        parts = list(self.cv1(x).chunk(2, dim=1))
        for m in self.m:
            parts.append(m(parts[-1]))
        return self.cv2(torch.cat(parts, 1))


class SPPF(nn.Module):
    def __init__(self, cin: int, cout: int, pool: int = 5):
        super().__init__()
        c_ = cin // 2
        self.cv1 = ConvBnSiLU(cin, c_, 1)
        self.cv2 = ConvBnSiLU(4 * c_, cout, 1)
        self.pool = pool

    def forward(self, x):
        x = self.cv1(x)
        k = self.pool
        y1 = F.max_pool2d(x, k, 1, k // 2)
        y2 = F.max_pool2d(y1, k, 1, k // 2)
        y3 = F.max_pool2d(y2, k, 1, k // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], 1))


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOv8Backbone(nn.Module):
    """DetectionModel graph minus the Detect head; returns the taps keyed
    as in the JAX package ("1".."5", "3_deep", "4_deep", "5_deep")."""

    def __init__(self, width: float = 0.75, depth: float = 0.67,
                 max_channels: int = 768):
        super().__init__()

        def c(ch):
            return min(int(round(ch * width)), max_channels)

        def d(n):
            return max(int(round(n * depth)), 1)

        layers = {
            "0": ConvBnSiLU(3, c(64), 3, 2),
            "1": ConvBnSiLU(c(64), c(128), 3, 2),
            "2": C2f(c(128), c(128), d(3), True),
            "3": ConvBnSiLU(c(128), c(256), 3, 2),
            "4": C2f(c(256), c(256), d(6), True),
            "5": ConvBnSiLU(c(256), c(512), 3, 2),
            "6": C2f(c(512), c(512), d(6), True),
            "7": ConvBnSiLU(c(512), c(1024), 3, 2),
            "8": C2f(c(1024), c(1024), d(3), True),
            "9": SPPF(c(1024), c(1024)),
            "12": C2f(c(1024) + c(512), c(512), d(3), False),
            "15": C2f(c(512) + c(256), c(256), d(3), False),
            "16": ConvBnSiLU(c(256), c(256), 3, 2),
            "18": C2f(c(256) + c(512), c(512), d(3), False),
            "19": ConvBnSiLU(c(512), c(512), 3, 2),
            "21": C2f(c(512) + c(1024), c(1024), d(3), False),
        }
        for name, m in layers.items():
            self.add_module(name, m)
        self.out_channels = (c(256), c(512), c(1024))

    def forward(self, x):
        m = self._modules
        taps = {}
        x0 = m["0"](x)
        taps["1"] = x0
        x1 = m["1"](x0)
        taps["2"] = x1
        x2 = m["2"](x1)
        x3 = m["3"](x2)
        taps["3"] = x3
        x4 = m["4"](x3)
        x5 = m["5"](x4)
        taps["4"] = x5
        x6 = m["6"](x5)
        x7 = m["7"](x6)
        taps["5"] = x7
        x8 = m["8"](x7)
        x9 = m["9"](x8)
        x12 = m["12"](torch.cat([_up2(x9), x6], 1))
        x15 = m["15"](torch.cat([_up2(x12), x4], 1))
        taps["3_deep"] = x15
        x16 = m["16"](x15)
        x18 = m["18"](torch.cat([x16, x12], 1))
        taps["4_deep"] = x18
        x19 = m["19"](x18)
        x21 = m["21"](torch.cat([x19, x9], 1))
        taps["5_deep"] = x21
        return taps


class YOLOV8PerceptualLoss(nn.Module):
    """Clip to [0, 1], zero-pad right and bottom to a multiple of 32, tap
    the backbone ("model") at eight layers, and sum the raw mean squared
    differences over the taps, per row."""

    def __init__(self, width: float = 0.75, depth: float = 0.67):
        super().__init__()
        self.model = YOLOv8Backbone(width, depth)

    def forward(self, target, input,
                feature_layers: Sequence[str] = ("1", "2", "3", "4", "5",
                                                 "3_deep", "4_deep",
                                                 "5_deep")):
        input, target = jclip01(input), jclip01(target)
        _, pr, _, pb = get_padding_size(*input.shape[-2:], p=32)
        if pr or pb:
            input = F.pad(input, (0, pr, 0, pb))
            target = F.pad(target, (0, pr, 0, pb))
        fs_in, fs_tg = self.model(input), self.model(target)
        losses = [torch.mean((fs_in[k] - fs_tg[k]) ** 2, dim=(1, 2, 3))
                  for k in fs_in if k in feature_layers]
        return torch.stack(losses).sum(0)


def load_yolo_backbone(loss: YOLOV8PerceptualLoss, npz_path: str):
    """The backbone of a YOLOv8 .npz (ultralytics names; the Detect head
    "model.22." dropped) into the loss, strict."""
    if not os.path.exists(npz_path):
        raise FileNotFoundError(f"YOLOv8 weights {npz_path} not found")
    _, bb_sd, _ = yolo_state_dicts(npz_path)
    loss.model.load_state_dict(bb_sd, strict=True)
    return loss
