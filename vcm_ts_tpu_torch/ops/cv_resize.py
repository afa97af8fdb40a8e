"""OpenCV's resizes, on the device: INTER_AREA (f32), INTER_LINEAR and
INTER_CUBIC (uint8).

The JAX package's detectors and OCR call cv2.resize on the host
(eval/mtcnn_native.py pyramid and crops, eval/yolo_native.py letterbox,
eval/ocr_native.py crops). The port runs the same arithmetic as torch ops
on the tensor's device; the coefficient tables are built on the host in
numpy, as OpenCV builds them (imgproc/src/resize.cpp), and uploaded.

- `resize_area` / `crop_resize_area` (f32, INTER_AREA): when both axes
  shrink, each output pixel is the coverage-weighted mean of the source
  pixels under it (OpenCV's computeResizeAreaTab), applied as a row matrix
  and a column matrix: two matmuls. F.interpolate(mode="area") is adaptive
  pooling, which gives other numbers for non-integer ratios. When an axis
  grows, OpenCV switches both axes to a two-tap rule (its `area_mode`
  branch of the generic resize), and so does this. Agreement with cv2:
  f32 sums in another order (tests/test_torch_imageio.py).
- `resize_linear_u8` (INTER_LINEAR): 11-bit fixed-point taps; the
  vertical pass rounds as OpenCV's SIMD path does (VResizeLinearVec_32s8u).
- `resize_cubic_u8` (INTER_CUBIC): 11-bit taps, A = -0.75, border
  replicate; the vertical pass in f32 fused multiply-adds, as OpenCV's SIMD
  path (VResizeCubicVec_32s8u).
OpenCV's scalar tail of a row rounds the fixed-point sums another way, so
a few pixels may differ by one level from cv2.
"""

from __future__ import annotations

import math

import numpy as np
import torch

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS
CROP_CHUNK = 64  # crops per pair of batched matmuls (bounds the memory)


# ------------------------------------------------------------- INTER_AREA
def _area_tab(ssize: int, dsize: int) -> np.ndarray:
    """(dsize, ssize) coverage weights of a shrinking axis
    (computeResizeAreaTab: float weights, each row sums to 1)."""
    scale = 1.0 / (dsize / ssize)
    m = np.zeros((dsize, ssize), np.float32)
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            m[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        m[dx, sx1:sx2] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            m[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return m


def _area_linear_tab(ssize: int, dsize: int) -> np.ndarray:
    """(dsize, ssize) two-tap weights of INTER_AREA on an axis when some
    axis grows (cv::resize's area_mode coefficients, edge clamped)."""
    inv = dsize / ssize
    scale = 1.0 / inv
    m = np.zeros((dsize, ssize), np.float32)
    for dx in range(dsize):
        sx = math.floor(dx * scale)
        fx = float(np.float32((dx + 1) - (sx + 1) * inv))
        fx = 0.0 if fx <= 0 else fx - math.floor(fx)
        if sx >= ssize - 1:
            m[dx, ssize - 1] += 1.0
            continue
        m[dx, sx] += np.float32(1.0 - np.float32(fx))
        m[dx, sx + 1] += np.float32(fx)
    return m


def area_matrices(sh: int, sw: int, dh: int, dw: int):
    """Row (dh, sh) and column (dw, sw) weight matrices of an INTER_AREA
    resize of an (sh, sw) image to (dh, dw)."""
    if dh <= sh and dw <= sw:
        return _area_tab(sh, dh), _area_tab(sw, dw)
    return _area_linear_tab(sh, dh), _area_linear_tab(sw, dw)


def resize_area(img: torch.Tensor, dh: int, dw: int) -> torch.Tensor:
    """(H, W, C) f32 -> (dh, dw, C), as cv2.resize(img, (dw, dh),
    interpolation=cv2.INTER_AREA)."""
    h, w, c = img.shape
    ry, rx = (torch.from_numpy(m).to(img.device)
              for m in area_matrices(h, w, dh, dw))
    rows = (ry @ img.reshape(h, w * c)).reshape(dh, w, c)
    return torch.einsum("xw,hwc->hxc", rx, rows)


def crop_resize_area(img: torch.Tensor, boxes, size: int) -> torch.Tensor:
    """(K, size, size, C) INTER_AREA resizes of the crops
    img[y1-1:y2, x1-1:x2] of (K, 4) integer boxes (1-indexed inclusive,
    already clamped to the image); an empty box gives a zero crop. Each
    crop's weights are embedded in full-image row and column matrices, so
    a chunk of crops is two batched matmuls."""
    h, w, c = img.shape
    boxes = np.asarray(boxes, np.int64).reshape(-1, 4)
    out = []
    for k0 in range(0, len(boxes), CROP_CHUNK):
        part = boxes[k0:k0 + CROP_CHUNK]
        ry = np.zeros((len(part), size, h), np.float32)
        rx = np.zeros((len(part), size, w), np.float32)
        for i, (x1, y1, x2, y2) in enumerate(part):
            if x2 < x1 or y2 < y1:
                continue
            my, mx = area_matrices(y2 - y1 + 1, x2 - x1 + 1, size, size)
            ry[i, :, y1 - 1:y2] = my
            rx[i, :, x1 - 1:x2] = mx
        ry_t = torch.from_numpy(ry).to(img.device)
        rx_t = torch.from_numpy(rx).to(img.device)
        rows = (ry_t.reshape(-1, h) @ img.reshape(h, w * c)).reshape(
            len(part), size, w, c)
        out.append(torch.einsum("kxw,kywc->kyxc", rx_t, rows))
    if not out:
        return img.new_zeros((0, size, size, c))
    return torch.cat(out)


# ------------------------------------------------ INTER_LINEAR / CUBIC u8
def _linear_taps(ssize: int, dsize: int):
    """Source index and 11-bit weights of each output along one axis
    (cv::resize, INTER_LINEAR): (dsize, 2) indexes, (dsize, 2) int32."""
    scale = 1.0 / (dsize / ssize)
    idx = np.zeros((dsize, 2), np.int64)
    wts = np.zeros((dsize, 2), np.int32)
    for d in range(dsize):
        fx = float(np.float32((d + 0.5) * scale - 0.5))
        sx = math.floor(fx)
        fx = float(np.float32(fx - sx))
        if sx < 0:
            sx, fx = 0, 0.0
        if sx >= ssize - 1:
            idx[d] = ssize - 1
            wts[d] = (COEF_SCALE, 0)
            continue
        idx[d] = (sx, sx + 1)
        wts[d] = (int(np.rint(np.float32(1.0 - fx) * COEF_SCALE)),
                  int(np.rint(np.float32(fx) * COEF_SCALE)))
    return idx, wts


def _cubic_coeffs(x: float) -> np.ndarray:
    a = np.float32(-0.75)
    x = np.float32(x)
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    return np.array([c0, c1, c2, 1 - c0 - c1 - c2], np.float32)


def _cubic_taps(ssize: int, dsize: int):
    """(dsize, 4) replicate-clamped indexes and 11-bit int32 weights
    (cv::resize, INTER_CUBIC)."""
    scale = 1.0 / (dsize / ssize)
    idx = np.zeros((dsize, 4), np.int64)
    wts = np.zeros((dsize, 4), np.int32)
    for d in range(dsize):
        fx = float(np.float32((d + 0.5) * scale - 0.5))
        sx = math.floor(fx)
        fx = float(np.float32(fx - sx))
        idx[d] = np.clip(np.arange(sx - 1, sx + 3), 0, ssize - 1)
        wts[d] = np.rint(_cubic_coeffs(fx) * COEF_SCALE).astype(np.int32)
    return idx, wts


def _hpass(img: torch.Tensor, idx, wts) -> torch.Tensor:
    """Integer horizontal pass: (H, W, C) uint8 -> (H, dw, C) int32."""
    dev = img.device
    src = img.to(torch.int32)
    i = torch.from_numpy(idx).to(dev)
    w = torch.from_numpy(wts).to(dev)
    acc = None
    for k in range(idx.shape[1]):
        term = src[:, i[:, k]] * w[:, k][None, :, None]
        acc = term if acc is None else acc + term
    return acc


def resize_linear_u8(img: torch.Tensor, dh: int, dw: int) -> torch.Tensor:
    """(H, W, C) uint8 -> (dh, dw, C) uint8, as cv2.resize(img, (dw, dh),
    interpolation=cv2.INTER_LINEAR)."""
    h, w, _ = img.shape
    buf = _hpass(img, *_linear_taps(w, dw))
    yi, yw = _linear_taps(h, dh)
    dev = img.device
    yi = torch.from_numpy(yi).to(dev)
    b = torch.from_numpy(yw).to(dev)[:, :, None, None]
    # OpenCV's SIMD vertical pass: (S >> 4) * beta >> 16 per tap, then
    # a rounding shift by 2
    s0 = ((buf[yi[:, 0]] >> 4) * b[:, 0]) >> 16
    s1 = ((buf[yi[:, 1]] >> 4) * b[:, 1]) >> 16
    return ((s0 + s1 + 2) >> 2).clamp(0, 255).to(torch.uint8)


def resize_cubic_u8(img: torch.Tensor, dh: int, dw: int) -> torch.Tensor:
    """(H, W, C) uint8 -> (dh, dw, C) uint8, as cv2.resize(img, (dw, dh),
    interpolation=cv2.INTER_CUBIC)."""
    h, w, _ = img.shape
    buf = _hpass(img, *_cubic_taps(w, dw))
    yi, yw = _cubic_taps(h, dh)
    dev = img.device
    yi = torch.from_numpy(yi).to(dev)
    beta = torch.from_numpy(
        yw.astype(np.float32) * np.float32(1.0 / (COEF_SCALE * COEF_SCALE))
    ).to(dev)[:, :, None, None]
    # f32 fused multiply-adds from the last tap to the first (the products
    # of two f32 values are exact in f64; round to f32 after each add)
    t = (buf[yi[:, 3]].float() * beta[:, 3]).double()
    for k in (2, 1, 0):
        t = (buf[yi[:, k]].double() * beta[:, k].double() + t).float().double()
    return torch.round(t).clamp(0, 255).to(torch.uint8)
