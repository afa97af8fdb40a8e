"""Task-aware perceptual losses (the port's copy of
vcm_ts_tpu/train/losses.py).

- FasterRCNNResNetPerceptualLoss: the five ResNet-50 slices of
  fasterrcnn_resnet50_fpn_v2's backbone, features normalised over the
  channels, inputs resized to 224x224;
- FasterRCNNFPNPerceptualLoss: the FPN v2 pyramid outputs 0/1/2/3/pool;
- the YOLOv8 loss lives in train/yolo_v8.py (YOLOV8PerceptualLoss).

NCHW modules with torchvision's key names: the "backbone.body.*" and
"backbone.fpn.*" tensors of
pretrained/fasterrcnn_resnet50_fpn_v2_coco-dd69338a.pth load with
strict=True once "backbone." is stripped. BatchNorm is frozen (eval-mode,
all four tensors buffers); the networks never train: they are frozen and
their gradient reaches only their input, the decoded frame. The detector
trainer alone turns a model's BatchNorm tensors into parameters
(`train_batch_norm_tensors`).

The convs go through ops/rowwise.conv2d: row by row on the CPU (oneDNN's
conv backward at batch > 1 corrupts the heap there), the whole batch on
the card inside rowwise.whole_batch(), as the train step runs. Numerics
follow the JAX package: `jnp.clip`'s gradient (0.5 where the input equals
a bound) through torch.maximum / torch.minimum, whose gradient splits at a
tie the same way; jax.image.resize's "nearest" is torch's "nearest-exact";
its "bilinear" without antialias is F.interpolate's (align_corners=False),
whose backward runs as ops/resize.bilinear_resize's (kernel E' on the
card: a fixed order of sums, as JAX's transposed einsum).
"""

from __future__ import annotations

import logging
import math
import os
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.layers import Conv2d
from ..ops.resize import bilinear_resize
from ..utils.device import resolve_device
from ..utils.weights import PRETRAINED, load_torch_state_dict

RCNN_WEIGHTS = "fasterrcnn_resnet50_fpn_v2_coco-dd69338a.pth"
YOLO_WEIGHTS = "yolov8m.pt"


class FrozenBatchNorm(nn.Module):
    """Eval-mode BatchNorm from imported statistics, computed as the JAX
    package does: x * inv + (beta - mean * inv) with
    inv = gamma / sqrt(var + eps). A checkpoint's `num_batches_tracked`
    is dropped on load, as torchvision's FrozenBatchNorm2d does."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x):
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


def train_batch_norm_tensors(model: nn.Module) -> nn.Module:
    """Make every FrozenBatchNorm's four tensors parameters of `model`, in
    place: the JAX package declares them flax params (train/losses.py
    FrozenBatchNorm), and its detector trainer differentiates and decays
    all four (tools/train_plate_detector.py). Names, values and the
    forward stay as they were; only a trainer's own copy of a model is
    passed here. Returns model."""
    for m in model.modules():
        if isinstance(m, FrozenBatchNorm):
            for name in ("weight", "bias", "running_mean", "running_var"):
                m.register_parameter(name, nn.Parameter(
                    m._buffers.pop(name)))
    return model


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False)


def _conv_bn(cin: int, cout: int, kernel: int, stride: int = 1):
    """torchvision's Conv2dNormActivation minus the activation: "0" the
    conv, "1" the norm."""
    return nn.Sequential(_conv(cin, cout, kernel, stride),
                         FrozenBatchNorm(cout))


class Bottleneck(nn.Module):
    """torchvision ResNet bottleneck (expansion 4, stride on conv2)."""

    def __init__(self, cin: int, width: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = _conv(width, width, 3, stride)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = _conv(width, width * 4, 1)
        self.bn3 = FrozenBatchNorm(width * 4)
        self.downsample = (_conv_bn(cin, width * 4, 1, stride) if downsample
                           else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def _layer(cin: int, width: int, blocks: int, stride: int):
    return nn.Sequential(Bottleneck(cin, width, stride, True),
                         *[Bottleneck(width * 4, width)
                           for _ in range(1, blocks)])


class ResNet50Body(nn.Module):
    """torchvision resnet50 trunk; returns the five slices the perceptual
    loss taps: "1" the stem (after its ReLU), "2"-"5" layer1-layer4."""

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = FrozenBatchNorm(64)
        self.layer1 = _layer(64, 64, 3, 1)
        self.layer2 = _layer(256, 128, 4, 2)
        self.layer3 = _layer(512, 256, 6, 2)
        self.layer4 = _layer(1024, 512, 3, 2)

    def forward(self, x):
        f1 = F.relu(self.bn1(self.conv1(x)))
        f2 = self.layer1(F.max_pool2d(f1, 3, 2, 1))
        f3 = self.layer2(f2)
        f4 = self.layer3(f3)
        f5 = self.layer4(f4)
        return {"1": f1, "2": f2, "3": f3, "4": f4, "5": f5}


class FPN(nn.Module):
    """torchvision FPN v2 head (Conv2dNormActivation inner and layer
    blocks, LastLevelMaxPool) over ResNet-50's C2-C5."""

    def __init__(self, out_channels: int = 256,
                 in_channels: Sequence[int] = (256, 512, 1024, 2048)):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            _conv_bn(c, out_channels, 1) for c in in_channels)
        self.layer_blocks = nn.ModuleList(
            _conv_bn(out_channels, out_channels, 3) for _ in in_channels)

    def forward(self, feats):  # {"2".."5"}: C2..C5
        inner = [blk(feats[k]) for blk, k in
                 zip(self.inner_blocks, ("2", "3", "4", "5"))]
        outs = [None] * 4
        last = outs[3] = inner[3]
        for i in range(2, -1, -1):
            last = inner[i] + F.interpolate(last, size=inner[i].shape[-2:],
                                            mode="nearest-exact")
            outs[i] = last
        results = {str(i): blk(o) for i, (blk, o) in
                   enumerate(zip(self.layer_blocks, outs))}
        # LastLevelMaxPool: max_pool2d(k=1, s=2)
        results["pool"] = results["3"][:, :, ::2, ::2]
        return results


_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def jclip01(x):
    """jnp.clip(x, 0, 1) with its gradient: 0.5 where x equals a bound."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _normalize_features(f, eps=1e-10):
    return f / (torch.sqrt(torch.sum(f ** 2, dim=1, keepdim=True)) + eps)


def _prep(x, resize: bool):
    mean = x.new_tensor(_IMAGENET_MEAN)[:, None, None]
    std = x.new_tensor(_IMAGENET_STD)[:, None, None]
    x = (jclip01(x) - mean) / std
    if resize:
        x = bilinear_resize(x, (224, 224))
    return x


def _tap_distance(fs_in, fs_tg, feature_layers):
    """Per row, the sum over the taps of the mean squared difference of
    the channel-normalised features."""
    losses = [torch.mean((_normalize_features(fs_in[k])
                          - _normalize_features(fs_tg[k])) ** 2,
                         dim=(1, 2, 3))
              for k in fs_in if k in feature_layers]
    return torch.stack(losses).sum(0)


class FasterRCNNResNetPerceptualLoss(nn.Module):
    """The ResNet-50 slices' distance; child "body" takes the checkpoint's
    backbone.body.* tensors."""

    def __init__(self):
        super().__init__()
        self.body = ResNet50Body()

    def forward(self, input, target, resize: bool = True,
                feature_layers: Sequence[str] = ("1", "2", "3", "4", "5")):
        return _tap_distance(self.body(_prep(input, resize)),
                             self.body(_prep(target, resize)),
                             feature_layers)


class FasterRCNNFPNPerceptualLoss(nn.Module):
    """The FPN pyramid's distance; children "body" and "fpn" take
    backbone.body.* and backbone.fpn.*."""

    def __init__(self):
        super().__init__()
        self.body = ResNet50Body()
        self.fpn = FPN()

    def feats(self, x, resize: bool = True):
        f = self.body(_prep(x, resize))
        return self.fpn({k: f[k] for k in ("2", "3", "4", "5")})

    def forward(self, input, target, resize: bool = True,
                feature_layers: Sequence[str] = ("0", "1", "2", "3",
                                                 "pool")):
        return _tap_distance(self.feats(input, resize),
                             self.feats(target, resize), feature_layers)


# ---------------------------------------------------------------- weights
@torch.no_grad()
def seeded_init(module: nn.Module, seed: int = 0) -> nn.Module:
    """flax's default init of a conv or dense layer, drawn with a
    torch.Generator: weights N(0, 1 / fan_in) (LeCun normal), biases 0;
    frozen BatchNorm keeps its identity statistics."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = m.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=g) / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
    return module


def load_rcnn_backbone(model: nn.Module, path: str) -> nn.Module:
    """Load a Faster-RCNN checkpoint's backbone.body.* (and backbone.fpn.*
    when the model has an "fpn" child) with strict=True."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"Faster-RCNN weights {path} not found")
    sd = {k[len("backbone."):]: v
          for k, v in load_torch_state_dict(path).items()
          if k.startswith("backbone.")}
    keep = tuple(f"{name}." for name, _ in model.named_children())
    model.load_state_dict({k: v for k, v in sd.items()
                           if k.startswith(keep)}, strict=True)
    return model


def frozen(model: nn.Module, device) -> nn.Module:
    """The module on `device`, in eval mode, with no trainable tensor."""
    return model.to(device).eval().requires_grad_(False)


def _nchw(t):
    return t.permute(0, 3, 1, 2).contiguous()


def get_perceptual_loss(cfg, device="cuda", seed: int = 0,
                        path: str | None = None):
    """pl_fn(target, decoded) -> (N,) for SOLVER.PL_MODEL (resnet, fpn or
    yolo), on NHWC f32 frames in [0, 1], with SOLVER.PL_LAYERS as the
    taps; `pl_fn.model` is the frozen network. Weights: `path`, else
    the repository's pretrained/ file (the Faster-RCNN .pth; YOLOv8m's
    .npz beside yolov8m.pt); when that is absent, a seeded init and a
    warning, as the JAX factory does."""
    logger = logging.getLogger("CORE")
    device = resolve_device(device)
    kind = cfg.SOLVER.PL_MODEL
    layers = tuple(cfg.SOLVER.PL_LAYERS)

    if kind in ("resnet", "fpn"):
        model = (FasterRCNNResNetPerceptualLoss() if kind == "resnet"
                 else FasterRCNNFPNPerceptualLoss())
        path = path or os.path.join(PRETRAINED, RCNN_WEIGHTS)
        if os.path.exists(path):
            load_rcnn_backbone(model, path)
        else:
            logger.warning(
                "Perceptual-loss weights '%s' not found; using random "
                "init (feature distance still provides a smoothness "
                "prior, but download the checkpoint for the reference "
                "behavior)", path)
            seeded_init(model, seed)
        model = frozen(model, device)

        def pl_fn(target, decoded):
            return model(_nchw(decoded), _nchw(target),
                         feature_layers=layers)

        pl_fn.model = model
        return pl_fn

    if kind == "yolo":
        from .yolo_v8 import YOLOV8PerceptualLoss, load_yolo_backbone

        model = YOLOV8PerceptualLoss()
        path = path or os.path.join(PRETRAINED, YOLO_WEIGHTS)
        npz = os.path.splitext(path)[0] + ".npz"
        if os.path.exists(npz):
            load_yolo_backbone(model, npz)
        else:
            logger.warning(
                "Perceptual-loss weights '%s' not found; using random init",
                npz)
            seeded_init(model, seed)
        model = frozen(model, device)

        def pl_fn(target, decoded):
            return model(_nchw(target), _nchw(decoded),
                         feature_layers=layers)

        pl_fn.model = model
        return pl_fn
    raise ValueError(f"Invalid perceptual loss: {kind}")
