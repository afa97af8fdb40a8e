"""MS-SSIM and PSNR (the port's copy of vcm_ts_tpu/ops/msssim.py), NHWC
tensors, pytorch_msssim's defaults: an 11-tap gaussian window with sigma
1.5, K = (0.01, 0.03), five scales with weights (0.0448, 0.2856, 0.3001,
0.2363, 0.1333), data_range 1.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_kernel(win_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(win_size, dtype=np.float64) - (win_size - 1) / 2.0
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(x, kernel):
    """Separable depthwise gaussian filter, VALID (NCHW). An input smaller
    than the window gives an empty output, as XLA's VALID conv does (the
    JAX package's MS-SSIM is then NaN: five scales need 161 pixels)."""
    c = x.shape[1]
    win = kernel.shape[0]
    if min(x.shape[2:]) < win:
        n, _, h, w = x.shape
        return x.new_empty((n, c, max(h - win + 1, 0), max(w - win + 1, 0)))
    x = F.conv2d(x, kernel.reshape(1, 1, win, 1).expand(c, 1, win, 1),
                 groups=c)
    return F.conv2d(x, kernel.reshape(1, 1, 1, win).expand(c, 1, 1, win),
                    groups=c)


def _ssim_per_channel(x, y, kernel, data_range=1.0, k=(0.01, 0.03)):
    c1 = (k[0] * data_range) ** 2
    c2 = (k[1] * data_range) ** 2
    mu_x = _blur(x, kernel)
    mu_y = _blur(y, kernel)
    sigma_x = _blur(x * x, kernel) - mu_x ** 2
    sigma_y = _blur(y * y, kernel) - mu_y ** 2
    sigma_xy = _blur(x * y, kernel) - mu_x * mu_y
    cs = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    ssim = ((2 * mu_x * mu_y + c1) / (mu_x ** 2 + mu_y ** 2 + c1)) * cs
    return ssim.mean(dim=(2, 3)), cs.mean(dim=(2, 3))


def _downsample2(x):
    """2x2 average pool with pytorch_msssim's symmetric padding of odd
    sizes (the pad counts in the average)."""
    h, w = x.shape[2:]
    return F.avg_pool2d(x, 2, padding=(h % 2, w % 2),
                        count_include_pad=True)


def ms_ssim(x, y, data_range: float = 1.0, win_size: int = 11,
            sigma: float = 1.5, weights=_WEIGHTS):
    """Multi-scale SSIM of NHWC batches; returns (N,)."""
    kernel = torch.from_numpy(_gaussian_kernel(win_size, sigma)).to(
        device=x.device, dtype=x.dtype)
    x, y = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
    mcs = []
    ssim = None
    for i in range(len(weights)):
        ssim, cs = _ssim_per_channel(x, y, kernel, data_range)
        if i < len(weights) - 1:
            mcs.append(torch.relu(cs))
            x = _downsample2(x)
            y = _downsample2(y)
    w = torch.tensor(weights, dtype=x.dtype, device=x.device)
    stack = torch.stack(mcs + [torch.relu(ssim)], 0)  # (L, N, C)
    return torch.prod(stack ** w[:, None, None], 0).mean(-1)


def psnr(x, y, data_range: float = 1.0):
    """Per-batch PSNR: (N,) over all other axes."""
    mse = ((x - y) ** 2).mean(dim=tuple(range(1, x.dim())))
    return 20 * torch.log10(data_range / torch.sqrt(mse.clamp_min(1e-12)))
