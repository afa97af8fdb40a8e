"""Bitstream container format + padding/shape utilities.

Byte-compatible with the reference's stream_helper
(DCVC_HEM/src/utils/stream_helper.py:24-144): big-endian struct headers,
I-frame = (H:u32, W:u32, q_index:u16, len:u32, bytes); P-frame =
(mv_q_index:u16, y_q_index:u16, len:u32, bytes).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def get_padding_size(height: int, width: int, p: int = 64):
    new_h = (height + p - 1) // p * p
    new_w = (width + p - 1) // p * p
    # pad right/bottom only, like the reference
    return 0, new_w - width, 0, new_h - height  # left, right, top, bottom


def get_downsampled_shape(height: int, width: int, p: int):
    new_h = (height + p - 1) // p * p
    new_w = (width + p - 1) // p * p
    return int(new_h / p + 0.5), int(new_w / p + 0.5)


def get_rounded_q(q_scale: float):
    q_scale = float(np.clip(q_scale, 0.01, 655.0))
    q_index = int(np.round(q_scale * 100))
    return q_index / 100, q_index


def filesize(filepath) -> int:
    p = Path(filepath)
    if not p.is_file():
        raise ValueError(f'Invalid file "{filepath}".')
    return p.stat().st_size


def encode_i(height: int, width: int, q_index: int, bit_stream: bytes, output):
    with Path(output).open("wb") as f:
        f.write(struct.pack(">2I", height, width))
        f.write(struct.pack(">1H", q_index))
        f.write(struct.pack(">1I", len(bit_stream)))
        if bit_stream:
            f.write(bit_stream)


def decode_i(inputpath):
    with Path(inputpath).open("rb") as f:
        height, width = struct.unpack(">2I", f.read(8))
        (q_index,) = struct.unpack(">1H", f.read(2))
        (stream_length,) = struct.unpack(">1I", f.read(4))
        bit_stream = f.read(stream_length)
    return height, width, q_index, bit_stream


def encode_p(string: bytes, mv_y_q_index: int, y_q_index: int, output):
    with Path(output).open("wb") as f:
        f.write(struct.pack(">2H", mv_y_q_index, y_q_index))
        f.write(struct.pack(">1I", len(string)))
        if string:
            f.write(string)


def decode_p(inputpath):
    with Path(inputpath).open("rb") as f:
        mv_y_q_index, y_q_index = struct.unpack(">2H", f.read(4))
        (string_length,) = struct.unpack(">1I", f.read(4))
        string = f.read(string_length)
    return mv_y_q_index, y_q_index, string


def pad_image(x: np.ndarray, p: int = 64):
    """Zero-pad an NHWC image to a multiple of p on the right/bottom
    (mode matches reference test_video.py:120-125: constant zeros)."""
    _, h, w, _ = x.shape
    _, pr, _, pb = get_padding_size(h, w, p)
    if pr == 0 and pb == 0:
        return x
    return np.pad(x, ((0, 0), (0, pb), (0, pr), (0, 0)), mode="constant")


def crop_image(x, height: int, width: int):
    return x[:, :height, :width, :]
