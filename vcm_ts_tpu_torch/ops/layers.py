"""Conv building blocks of the codec models (NCHW, channels_last memory).

Counterpart of vcm_ts_tpu/ops/layers.py. Children carry the reference torch
state-dict names ("0", "conv1", "fc", ...), so the state dict that
utils/weights.py makes from the JAX parameters loads with strict=True.

`SubpelConv` always runs the JAX package's fast-shuffle configuration: its
weights are permuted to k-major order (once per load and cached, or every
call while a gradient to them is recorded), and the shuffle goes through
kernel B (1x1 convs, fused) or kernel C (after a cuDNN 3x3 conv). The
TPU-only conv lowerings of the JAX package
(`_conv_same_cout_padded`, `_conv_same_im2col_dot`) are plain convs here.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .rowwise import conv2d, linear, mean_hw
from .resize import max_pool2
from .subpel import (permute_out_channels, pixel_shuffle_relayout,
                     subpel_conv1x1)


def to_nchw(t: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW with channels_last memory: a view when `t` is dense
    NHWC, one copy otherwise."""
    return t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def to_nhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC view (contiguous when `t` has channels_last memory)."""
    return t.permute(0, 2, 3, 1)


class Conv2d(nn.Conv2d):
    """nn.Conv2d that computes in the promoted dtype of its input and its
    weights, as flax nn.Conv(dtype=None) does: a bf16 input to f32 weights
    runs and comes out in f32, an f32 input to bf16 weights stays f32."""

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        w = self.weight.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        return conv2d(x.to(dt), w, b, self.stride, self.padding)


class Linear(nn.Linear):
    """nn.Linear with flax nn.Dense(dtype=None)'s dtype promotion."""

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return linear(x.to(dt), self.weight.to(dt), b)


def conv(cin: int, cout: int, kernel: int = 3, stride: int = 1) -> Conv2d:
    """Promoting Conv2d with the JAX package's explicit k//2 padding."""
    return Conv2d(cin, cout, kernel, stride, padding=kernel // 2)


def pixel_shuffle(x, r: int):
    """Depth-to-space in torch PixelShuffle channel order."""
    return F.pixel_shuffle(x, r)


class SubpelConv(nn.Module):
    """Conv + PixelShuffle upsampler; child conv "0" holds torch's c-major
    weights, from which the k-major form is derived. Without a recorded
    gradient it is derived once and cached (keyed on the weights' storage
    and version, so a reload or .to() refreshes it); while autograd records
    and the weights need a gradient, it is derived every call by the same
    permutation, so the gradient reaches child "0"."""

    def __init__(self, cin: int, features: int, r: int = 2, kernel: int = 3):
        super().__init__()
        self.features, self.r, self.kernel = features, r, kernel
        self.add_module("0", conv(cin, features * r * r, kernel))
        self._kmajor = None

    def _permute(self, w, b):
        r, f = self.r, self.features
        wp = permute_out_channels(w, r)
        bp = permute_out_channels(b, r)
        if self.kernel == 1:
            cin = wp.shape[1]
            wp = wp.reshape(r * r, f, cin).permute(0, 2, 1).contiguous()
            return wp, bp.reshape(r * r, f).contiguous()
        return wp.contiguous(memory_format=torch.channels_last), bp

    def kmajor_weights(self):
        """(k-major weights, bias)."""
        c = self._modules["0"]
        if torch.is_grad_enabled() and (c.weight.requires_grad
                                        or c.bias.requires_grad):
            return self._permute(c.weight, c.bias)
        key = (c.weight.data_ptr(), c.weight._version, c.bias.data_ptr(),
               c.bias._version, c.weight.dtype)
        if self._kmajor is None or self._kmajor[0] != key:
            with torch.no_grad():
                self._kmajor = (key, *self._permute(c.weight.detach(),
                                                    c.bias.detach()))
        return self._kmajor[1], self._kmajor[2]

    def forward(self, x):
        w, b = self.kmajor_weights()
        # promote like the JAX package (f32 params + bf16 input -> f32)
        dt = torch.promote_types(x.dtype, w.dtype)
        x = x.to(dt).contiguous(memory_format=torch.channels_last)
        w, b = w.to(dt), b.to(dt)
        if self.kernel == 1:
            return subpel_conv1x1(x, w, b, self.r)
        y = conv2d(x, w, b, padding=self.kernel // 2)
        return pixel_shuffle_relayout(
            y.contiguous(memory_format=torch.channels_last), self.r)


class ResidualBlock(nn.Module):
    """Two 3x3 convs + identity."""

    def __init__(self, ch: int, slope: float = 0.01):
        super().__init__()
        self.conv1 = conv(ch, ch)
        self.conv2 = conv(ch, ch)
        self.slope = slope

    def forward(self, x):
        out = F.leaky_relu(self.conv1(x), self.slope)
        out = F.leaky_relu(self.conv2(out), self.slope)
        return x + out


class ResidualBlockWithStride(nn.Module):
    """Strided residual downsampler."""

    def __init__(self, cin: int, ch: int, stride: int = 2):
        super().__init__()
        self.conv1 = conv(cin, ch, 3, stride)
        self.conv2 = conv(ch, ch)
        self.downsample = conv(cin, ch, 1, stride) if stride != 1 else None

    def forward(self, x):
        out = F.leaky_relu(self.conv1(x), 0.01)
        out = F.leaky_relu(self.conv2(out), 0.1)
        identity = x if self.downsample is None else self.downsample(x)
        return out + identity


class ResidualBlockUpsample(nn.Module):
    """Subpixel-upsampling residual block."""

    def __init__(self, cin: int, ch: int, r: int = 2):
        super().__init__()
        self.subpel_conv = SubpelConv(cin, ch, r, kernel=1)
        self.conv = conv(ch, ch)
        self.upsample = SubpelConv(cin, ch, r, kernel=1)

    def forward(self, x):
        out = F.leaky_relu(self.subpel_conv(x), 0.01)
        out = F.leaky_relu(self.conv(out), 0.1)
        return out + self.upsample(x)


class ResBlock(nn.Module):
    """Residual block with optional bottleneck and relu placement; a slope
    below 1e-4 is a plain ReLU."""

    def __init__(self, ch: int, slope: float = 0.01,
                 start_from_relu: bool = True, end_with_relu: bool = False,
                 bottleneck: bool = False):
        super().__init__()
        mid = ch // 2 if bottleneck else ch
        self.conv1 = conv(ch, mid)
        self.conv2 = conv(mid, ch)
        self.slope = 0.0 if slope < 0.0001 else slope
        self.start_from_relu = start_from_relu
        self.end_with_relu = end_with_relu

    def _act(self, v):
        return F.leaky_relu(v, self.slope) if self.slope > 0 else F.relu(v)

    def forward(self, x):
        out = self._act(x) if self.start_from_relu else x
        out = self.conv2(self._act(self.conv1(out)))
        if self.end_with_relu:
            out = self._act(out)
        return x + out


class SELayer(nn.Module):
    """Squeeze-and-excitation; the global mean accumulates in f32."""

    def __init__(self, ch: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(
            Linear(ch, ch // reduction, bias=False), nn.ReLU(),
            Linear(ch // reduction, ch, bias=False), nn.Sigmoid())

    def forward(self, x):
        y = mean_hw(x).to(x.dtype)
        return x * self.fc(y)[:, :, None, None]


class ConvBlockResidual(nn.Module):
    """Conv-conv-SE with a 1x1 shortcut."""

    def __init__(self, cin: int, ch: int, se_layer: bool = True):
        super().__init__()
        parts = [conv(cin, ch), nn.LeakyReLU(0.01), conv(ch, ch)]
        if se_layer:
            parts.append(SELayer(ch))
        self.conv = nn.Sequential(*parts)
        self.up_dim = conv(cin, ch, 1)

    def forward(self, x):
        return self.conv(x) + self.up_dim(x)


class UNet(nn.Module):
    """Two-level UNet with SE conv blocks."""

    def __init__(self, cin: int, features: int = 64):
        super().__init__()
        self.conv1 = ConvBlockResidual(cin, 32)
        self.conv2 = ConvBlockResidual(32, 64)
        self.conv3 = ConvBlockResidual(64, 128)
        self.context_refine = nn.Sequential(
            *[ResBlock(128, slope=0.0) for _ in range(4)])
        self.up3 = SubpelConv(128, 64, 2, kernel=1)
        self.up_conv3 = ConvBlockResidual(128, 64)
        self.up2 = SubpelConv(64, 32, 2, kernel=1)
        self.up_conv2 = ConvBlockResidual(64, features)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(max_pool2(x1))
        x3 = self.context_refine(self.conv3(max_pool2(x2)))
        d3 = self.up_conv3(torch.cat([x2, self.up3(x3)], dim=1))
        d2 = self.up2(d3)
        return self.up_conv2(torch.cat([x1, d2], dim=1))


class MEBasic(nn.Module):
    """One SpyNet pyramid level: five 7x7 convs."""

    def __init__(self, cin: int = 8):
        super().__init__()
        self.conv1 = conv(cin, 32, 7)
        self.conv2 = conv(32, 64, 7)
        self.conv3 = conv(64, 32, 7)
        self.conv4 = conv(32, 16, 7)
        self.conv5 = conv(16, 2, 7)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        x = F.relu(self.conv3(x))
        x = F.relu(self.conv4(x))
        return self.conv5(x)


def enc_dec_models(input_ch: int, output_ch: int, ch: int):
    """Autoencoder stacks of the MV codec and the intra codec; returns
    (encoder, decoder) with torch Sequential indices as names."""
    enc = nn.Sequential(
        ResidualBlockWithStride(input_ch, ch, 2), ResidualBlock(ch),
        ResidualBlockWithStride(ch, ch, 2), ResidualBlock(ch),
        ResidualBlockWithStride(ch, ch, 2), ResidualBlock(ch),
        conv(ch, ch, 3, 2))
    dec = nn.Sequential(
        ResidualBlock(ch), ResidualBlockUpsample(ch, ch, 2),
        ResidualBlock(ch), ResidualBlockUpsample(ch, ch, 2),
        ResidualBlock(ch), ResidualBlockUpsample(ch, ch, 2),
        ResidualBlock(ch), SubpelConv(ch, output_ch, 2, kernel=1))
    return enc, dec


def hyper_enc_dec_models(y_ch: int, z_ch: int):
    """Hyper-prior autoencoder stacks; returns (encoder, decoder)."""
    enc = nn.Sequential(
        conv(y_ch, z_ch), nn.LeakyReLU(0.01),
        conv(z_ch, z_ch), nn.LeakyReLU(0.01),
        conv(z_ch, z_ch, 3, 2), nn.LeakyReLU(0.01),
        conv(z_ch, z_ch), nn.LeakyReLU(0.01),
        conv(z_ch, z_ch, 3, 2))
    y15 = y_ch * 3 // 2
    dec = nn.Sequential(
        conv(z_ch, y_ch), nn.LeakyReLU(0.01),
        SubpelConv(y_ch, y_ch, 2, kernel=1), nn.LeakyReLU(0.01),
        conv(y_ch, y15), nn.LeakyReLU(0.01),
        SubpelConv(y15, y15, 2, kernel=1), nn.LeakyReLU(0.01),
        conv(y15, y_ch * 2))
    return enc, dec
