"""PNG reading and writing on zlib and numpy, and the PNG sequence reader.

The port's counterpart of vcm_ts_tpu/codec/png_io.py (`PNGReader`,
`save_image`, `read_image`), plus `imread` / `imwrite`, which the pipeline
uses where the JAX package calls cv2.imread / cv2.imwrite. The port needs
neither PIL nor OpenCV, so this module is its own PNG codec: 8-bit gray,
gray+alpha, RGB and RGBA, not interlaced. Pixels are RGB in memory (the
JAX pipeline's BGR arrays write the same files).

Decoding undoes all five row filters. None, Sub and Up are whole-row numpy
operations. Average and Paeth predict a byte from its left neighbour, so
an image that uses them is decoded along anti-diagonals: every pixel on
one diagonal depends only on the two diagonals before it, so each
diagonal is one vectorised step (H + W - 1 steps in all).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG color type -> channels
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _chunks(data: bytes):
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return


def _unfilter_rows(filters, raw):
    """Filters None/Sub/Up only: one numpy step per row."""
    out = np.empty_like(raw)
    prev = np.zeros_like(raw[0])
    for r, f in enumerate(filters):
        if f == 0:
            out[r] = raw[r]
        elif f == 1:
            out[r] = np.cumsum(raw[r], axis=0, dtype=np.uint8)
        else:
            out[r] = raw[r] + prev
        prev = out[r]
    return out


def _unfilter_diagonals(filters, raw):
    """Any filters: one vectorised step per anti-diagonal r + x = t."""
    h, w, c = raw.shape
    o = np.zeros((h + 1, w + 1, c), np.int16)  # row -1 and column -1 are 0
    raw = raw.astype(np.int16)
    f = filters.astype(np.int16)[:, None]
    for t in range(h + w - 1):
        r = np.arange(max(0, t - w + 1), min(h - 1, t) + 1)
        x = t - r
        a = o[r + 1, x]      # left
        b = o[r, x + 1]      # up
        cc = o[r, x]         # up-left
        fr = f[r]
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, cc))
        pred = np.select([fr == 1, fr == 2, fr == 3, fr == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        o[r + 1, x + 1] = (raw[r, x] + pred) & 255
    return o[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """(H, W, C) uint8, C = 1 (gray), 2 (gray+alpha), 3 (RGB), 4 (RGBA)."""
    with open(path, "rb") as fh:
        data = fh.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit gray/RGB(A), not interlaced, "
                         f"is supported (depth {depth}, color type {color}, "
                         f"interlace {interlace})")
    c = _CHANNELS[color]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows[:h * (1 + w * c)].reshape(h, 1 + w * c)
    filters, raw = rows[:, 0], rows[:, 1:].reshape(h, w, c)
    if filters.max(initial=0) > 4:
        raise ValueError(f"{path}: bad row filter {filters.max()}")
    if np.all(filters <= 2):
        return _unfilter_rows(filters, raw)
    return _unfilter_diagonals(filters, raw)


def _filter(img: np.ndarray, filter_type: int) -> np.ndarray:
    """Every row of `img` (H, W, C) uint8 filtered with one filter type."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    if filter_type == 0:
        pred = np.zeros_like(x)
    elif filter_type == 1:
        pred = a
    elif filter_type == 2:
        pred = b
    elif filter_type == 3:
        pred = (a + b) >> 1
    elif filter_type == 4:
        cc = np.zeros_like(x)
        cc[1:, 1:] = x[:-1, :-1]
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        pred = np.where((pa <= pb) & (pa <= pc), a,
                        np.where(pb <= pc, b, cc))
    else:
        raise ValueError(f"PNG filter type {filter_type} is not 0-4")
    return ((x - pred) & 255).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path: str, img: np.ndarray, filter_type: int = 2) -> None:
    """Write (H, W) or (H, W, C) uint8, C in 1-4, every row filtered with
    `filter_type` (default Up, which decodes row by row), zlib level 6."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8 pixels, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"write_png: {c} channels")
    rows = np.concatenate([np.full((h, 1), filter_type, np.uint8),
                           _filter(img, filter_type).reshape(h, w * c)], 1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(_SIG + _chunk(b"IHDR", ihdr)
                 + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                 + _chunk(b"IEND", b""))


def imread(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB: gray is repeated, alpha dropped (as
    cv2.imread(path) does, in RGB order)."""
    img = read_png(path)
    if img.shape[2] in (1, 2):
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def imwrite(path: str, rgb: np.ndarray) -> None:
    write_png(path, rgb)


class PNGReader:
    """Sequential imN.png / imNNNNN.png reader of float32 RGB in [0, 1]."""

    def __init__(self, src_folder: str):
        self.src_folder = src_folder
        pngs = os.listdir(src_folder)
        if "im1.png" in pngs:
            self.padding = 1
        elif "im00001.png" in pngs:
            self.padding = 5
        else:
            raise ValueError("unknown image naming convention; please specify")
        self.current_frame_index = 1
        self.eof = False

    def read_one_frame(self, get_png_path: bool = False):
        """Returns (H, W, 3) float32 RGB in [0,1], or None at EOF."""
        if self.eof:
            return (None, None) if get_png_path else None
        png_path = os.path.join(
            self.src_folder,
            f"im{str(self.current_frame_index).zfill(self.padding)}.png")
        if not os.path.exists(png_path):
            self.eof = True
            return (None, None) if get_png_path else None
        rgb = imread(png_path).astype(np.float32) / 255.0
        self.current_frame_index += 1
        if get_png_path:
            return rgb, png_path
        return rgb

    def close(self):
        self.current_frame_index = 1
        self.eof = False


def save_image(img, save_path: str):
    """img: (1, H, W, 3) or (H, W, 3) float in [0,1]."""
    img = np.asarray(img)
    if img.ndim == 4:
        img = img[0]
    write_png(save_path, np.clip(np.rint(img * 255), 0, 255).astype(np.uint8))


def read_image(path: str) -> np.ndarray:
    """(1, H, W, 3) float32 RGB in [0,1]."""
    return (imread(path).astype(np.float32) / 255.0)[None]
