"""Resampling ops on NCHW tensors with the JAX package's semantics.

Counterpart of vcm_ts_tpu/ops/resize.py: `jax.image.resize(..., "bilinear",
antialias=False)` is torch's half-pixel bilinear interpolation
(align_corners=False) for the exact 2x factors used here.
"""

from __future__ import annotations

import torch.nn.functional as F


def bilinear_up2(x):
    """2x bilinear upsampling, half-pixel centers."""
    _, _, h, w = x.shape
    return F.interpolate(x, size=(h * 2, w * 2), mode="bilinear",
                         align_corners=False, antialias=False)


def bilinear_down2(x):
    """0.5x bilinear downsampling, half-pixel centers, no antialias."""
    _, _, h, w = x.shape
    return F.interpolate(x, size=(h // 2, w // 2), mode="bilinear",
                         align_corners=False, antialias=False)


def avg_pool2(x):
    """2x2 average pooling with stride 2."""
    return F.avg_pool2d(x, 2)


def max_pool2(x):
    """2x2 max pooling with stride 2 (UNet downsampling)."""
    return F.max_pool2d(x, 2)
