"""Video-model submodules: SpyNet motion estimation and the DMC conv stacks.

Counterpart of vcm_ts_tpu/models/video_net.py, as NCHW modules (channels_last
memory) whose children carry the reference state-dict names.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.layers import MEBasic, ResBlock, SubpelConv, UNet, conv
from ..ops.resize import avg_pool2, bilinear_up2
from ..ops.warp import flow_warp
from ..ops.warp_twopass import flow_warp_twopass

CL = torch.channels_last


class MESpynet(nn.Module):
    """Coarse-to-fine 4-level SpyNet; `fast_warp` warps with the two-pass
    warp (kernel D) in place of the exact warp. `spatial`: the SpatialAxis
    of a model split by rows (parallel/spatial.py), else None."""

    spatial = None

    def __init__(self, levels: int = 4, fast_warp: bool = False):
        super().__init__()
        self.levels, self.fast_warp = levels, fast_warp
        self.moduleBasic = nn.ModuleList(MEBasic() for _ in range(levels))

    def _warp(self, im, flow, level: int):
        sp = self.spatial
        if self.fast_warp:
            # the displacement bound shrinks with the pyramid level
            d = max(4, 16 >> level)
            if sp is None:
                return flow_warp_twopass(im, flow, d)
            return sp.warp_twopass(im, flow, d)
        return flow_warp(im, flow) if sp is None else sp.warp([im], flow)[0]

    def _pool(self, x):
        sp = self.spatial
        return avg_pool2(x) if sp is None else sp.pool(avg_pool2, x)

    def _up2(self, x):
        sp = self.spatial
        return bilinear_up2(x) if sp is None else sp.resize(bilinear_up2, x)

    def forward(self, im1, im2):
        im1_list = [im1]
        im2_list = [im2]
        for _ in range(self.levels - 1):
            im1_list.append(self._pool(im1_list[-1]))
            im2_list.append(self._pool(im2_list[-1]))

        n, _, h_c, w_c = im2_list[-1].shape
        h_f = h_c // 2
        if self.spatial is not None:  # this rank's rows of the flow plane
            sp = self.spatial
            r0, r1 = sp.span(sp.global_rows(im2_list[-1], 2) // 2)
            h_f = r1 - r0
        flow = torch.zeros((n, 2, h_f, w_c // 2), dtype=im1.dtype,
                           device=im1.device).contiguous(memory_format=CL)
        for level in range(self.levels):
            flow_up = (self._up2(flow) * 2.0).contiguous(memory_format=CL)
            i = self.levels - 1 - level
            warped = self._warp(im2_list[i].contiguous(memory_format=CL),
                                flow_up, i)
            flow = flow_up + self.moduleBasic[level](
                torch.cat([im1_list[i], warped, flow_up], dim=1))
        return flow


class FeatureExtractor(nn.Module):
    """3-scale conv + ResBlock pyramid."""

    def __init__(self, channel: int = 64):
        super().__init__()
        self.conv1 = conv(channel, channel)
        self.res_block1 = ResBlock(channel)
        self.conv2 = conv(channel, channel, 3, 2)
        self.res_block2 = ResBlock(channel)
        self.conv3 = conv(channel, channel, 3, 2)
        self.res_block3 = ResBlock(channel)

    def forward(self, feature):
        layer1 = self.res_block1(self.conv1(feature))
        layer2 = self.res_block2(self.conv2(layer1))
        layer3 = self.res_block3(self.conv3(layer2))
        return layer1, layer2, layer3


class MultiScaleContextFusion(nn.Module):
    """Cross-scale context mixer."""

    def __init__(self, channel: int = 64):
        super().__init__()
        c = channel
        self.conv3_up = SubpelConv(c, c, 2, kernel=3)
        self.res_block3_up = ResBlock(c)
        self.conv3_out = conv(c, c)
        self.res_block3_out = ResBlock(c)
        self.conv2_up = SubpelConv(2 * c, c, 2, kernel=3)
        self.res_block2_up = ResBlock(c)
        self.conv2_out = conv(2 * c, c)
        self.res_block2_out = ResBlock(c)
        self.conv1_out = conv(2 * c, c)
        self.res_block1_out = ResBlock(c)

    def forward(self, context1, context2, context3):
        c3_up = self.res_block3_up(self.conv3_up(context3))
        c3_out = self.res_block3_out(self.conv3_out(context3))
        cat32 = torch.cat((c3_up, context2), dim=1)
        c2_up = self.res_block2_up(self.conv2_up(cat32))
        c2_out = self.res_block2_out(self.conv2_out(cat32))
        cat21 = torch.cat((c2_up, context1), dim=1)
        c1_out = self.res_block1_out(self.conv1_out(cat21))
        return context1 + c1_out, context2 + c2_out, context3 + c3_out


def _bottleneck_res(ch: int) -> ResBlock:
    return ResBlock(ch, bottleneck=True, slope=0.1, start_from_relu=True,
                    end_with_relu=True)


class ContextualEncoder(nn.Module):
    """x + multi-scale contexts -> latent y."""

    def __init__(self, channel_N: int = 64, channel_M: int = 96):
        super().__init__()
        n = channel_N
        self.conv1 = conv(n + 3, n, 3, 2)
        self.res1 = _bottleneck_res(n * 2)
        self.conv2 = conv(n * 2, n, 3, 2)
        self.res2 = _bottleneck_res(n * 2)
        self.conv3 = conv(n * 2, n, 3, 2)
        self.conv4 = conv(n, channel_M, 3, 2)

    def forward(self, x, context1, context2, context3):
        f = self.conv1(torch.cat([x, context1], dim=1))
        f = self.conv2(self.res1(torch.cat([f, context2], dim=1)))
        f = self.conv3(self.res2(torch.cat([f, context3], dim=1)))
        return self.conv4(f)


class ContextualDecoder(nn.Module):
    """latent y + contexts -> 32-channel recon features."""

    def __init__(self, channel_N: int = 64, channel_M: int = 96):
        super().__init__()
        n = channel_N
        self.up1 = SubpelConv(channel_M, n, 2, kernel=3)
        self.up2 = SubpelConv(n, n, 2, kernel=3)
        self.res1 = _bottleneck_res(n * 2)
        self.up3 = SubpelConv(n * 2, n, 2, kernel=3)
        self.res2 = _bottleneck_res(n * 2)
        self.up4 = SubpelConv(n * 2, 32, 2, kernel=3)

    def forward(self, x, context2, context3):
        f = self.up2(self.up1(x))
        f = self.up3(self.res1(torch.cat([f, context3], dim=1)))
        f = self.res2(torch.cat([f, context2], dim=1))
        return self.up4(f)


class ReconGeneration(nn.Module):
    """Context + recon features -> frame, via two UNets."""

    def __init__(self, channel: int = 64):
        super().__init__()
        self.first_conv = conv(channel + 32, channel)
        self.unet_1 = UNet(channel, channel)
        self.unet_2 = UNet(channel, channel)
        self.recon_conv = conv(channel, 3)

    def forward(self, ctx, res):
        f = self.first_conv(torch.cat((ctx, res), dim=1))
        f = self.unet_2(self.unet_1(f))
        return f, self.recon_conv(f)
