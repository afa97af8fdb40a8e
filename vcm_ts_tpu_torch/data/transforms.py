"""Frame-stack preprocessing as a functional numpy pipeline (the port's
copy of vcm_ts_tpu/data/transforms.py, unchanged: host numpy, so the same
seed draws the same crops in either package).

Steps are pure functions over a dict of named (T, H, W, C) frame stacks:
crop, pad-to-multiple, BGR<->RGB, clip, scale-to-unit. A step is any
callable `dict[str, ndarray] -> dict[str, ndarray]`; `Pipeline` composes
them. Geometric steps (crops, padding) apply one window to every stream,
so inputs, targets, masks and residuals stay aligned.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class Pipeline:
    """Compose (streams -> streams) steps; call with keyword streams.

    >>> pipe = Pipeline(center_crop(256, 256), to_unit_float())
    >>> out = pipe(inputs=frames, targets=frames.copy())
    """

    def __init__(self, *steps):
        self.steps = [s for s in steps if s is not None]

    def __call__(self, **streams):
        streams = {k: v for k, v in streams.items() if v is not None}
        for step in self.steps:
            streams = step(streams)
        return streams


def _spatial_shape(streams):
    shapes = {v.shape[-3:-1] for v in streams.values()}
    if len(shapes) != 1:
        raise ValueError(f"streams disagree on spatial shape: {shapes}")
    return shapes.pop()


def _crop_all(streams, y0, x0, h, w):
    return {k: v[..., y0:y0 + h, x0:x0 + w, :] for k, v in streams.items()}


def random_crop(width: int, height: int,
                rng: Optional[np.random.Generator] = None):
    """Same random (height, width) window from every stream (train path)."""
    gen = rng if rng is not None else np.random.default_rng()

    def step(streams):
        h, w = _spatial_shape(streams)
        if h < height or w < width:
            raise ValueError(f"frames {h}x{w} smaller than "
                             f"crop {height}x{width}")
        y0 = int(gen.integers(0, h - height + 1))
        x0 = int(gen.integers(0, w - width + 1))
        return _crop_all(streams, y0, x0, height, width)

    return step


def center_crop(width: int, height: int):
    """Central (height, width) window from every stream (eval path)."""

    def step(streams):
        h, w = _spatial_shape(streams)
        if h < height or w < width:
            raise ValueError(f"frames {h}x{w} smaller than "
                             f"crop {height}x{width}")
        return _crop_all(streams, (h - height) // 2, (w - width) // 2,
                         height, width)

    return step


def pad_to_multiple(stack: np.ndarray, factor: int) -> np.ndarray:
    """Zero-pad H and W (bottom/right) up to the next multiple of `factor`
    — the codec's downsampling stack needs stride-aligned extents."""
    if stack.ndim not in (3, 4):
        raise ValueError(f"expected (T,)H,W,C array, got ndim={stack.ndim}")
    h, w = stack.shape[-3], stack.shape[-2]
    ph, pw = -h % factor, -w % factor
    if not (ph or pw):
        return stack
    pad = [(0, 0)] * stack.ndim
    pad[-3], pad[-2] = (0, ph), (0, pw)
    return np.pad(stack, pad)


def pad_streams_to_multiple(factor: int):
    def step(streams):
        return {k: pad_to_multiple(v, factor) for k, v in streams.items()}

    return step


def reverse_channels():
    """BGR <-> RGB (cv2 decodes BGR; the models consume RGB)."""

    def step(streams):
        return {k: np.ascontiguousarray(v[..., ::-1])
                for k, v in streams.items()}

    return step


def to_unit_float(scaled: Sequence[str] = ("inputs", "targets")):
    """Cast to float32 clipped to [0, 255]; streams named in `scaled` are
    additionally mapped to [0, 1] (masks/residuals typically stay 0-255)."""
    scaled = frozenset(scaled)

    def step(streams):
        out = {}
        for k, v in streams.items():
            v = np.clip(np.asarray(v, np.float32), 0.0, 255.0)
            out[k] = v / 255.0 if k in scaled else v
        return out

    return step


def to_float32():
    """Cast to float32 clipped to [0, 255] without rescaling."""
    return to_unit_float(scaled=())
