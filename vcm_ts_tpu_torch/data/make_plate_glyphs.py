"""Generate plate_glyphs.npz: the plate OCR trainer's characters,
rasterised once with PIL so that the trainers need no PIL or font files.

    python -m vcm_ts_tpu_torch.data.make_plate_glyphs [--out PATH]

The atlas holds the 36 characters of CHARSET in the four training faces
of the JAX package's tools/train_plate_ocr.py (TRAIN_FONTS: PIL's default
face and DejaVu Sans, Serif Bold and Sans Mono) at the sizes its
render_plate draws (22-33). Per glyph: its 8-bit coverage (PIL's
anti-aliased mask, font.getmask2 with the left-ascender anchor), the
offset of that mask from the pen position, and the pen advance
(font.getlength). The held-out faces of tools/ocr_domain_gate.py are not
in it.

This script alone imports PIL; it raises where PIL or a face is missing.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..eval.ocr_native import CHARSET

DEJAVU = "/usr/share/fonts/truetype/dejavu"
FACES = ("default", "DejaVuSans.ttf", "DejaVuSerif-Bold.ttf",
         "DejaVuSansMono.ttf")
SIZES = tuple(range(22, 34))
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "plate_glyphs.npz")


def _font(face: str, size: int):
    try:
        from PIL import ImageFont
    except ImportError as e:
        raise ImportError("make_plate_glyphs needs PIL (Pillow) to "
                          "rasterise the glyphs") from e
    if face == "default":
        return ImageFont.load_default(size=size)
    path = os.path.join(DEJAVU, face)
    if not os.path.exists(path):
        raise FileNotFoundError(f"font {path} not found")
    return ImageFont.truetype(path, size=size)


def build() -> dict:
    """The atlas arrays: pixels (flat uint8 coverage), start / shape /
    offset (F, S, 36[, 2]) int32, advance (F, S, 36) float32."""
    nf, ns, nc = len(FACES), len(SIZES), len(CHARSET)
    start = np.zeros((nf, ns, nc), np.int64)
    shape = np.zeros((nf, ns, nc, 2), np.int32)
    offset = np.zeros((nf, ns, nc, 2), np.int32)
    advance = np.zeros((nf, ns, nc), np.float32)
    pixels, pos = [], 0
    for f, face in enumerate(FACES):
        for s, size in enumerate(SIZES):
            font = _font(face, size)
            for c, ch in enumerate(CHARSET):
                mask, (ox, oy) = font.getmask2(ch, mode="L", anchor="la")
                w, h = mask.size
                cov = np.asarray(mask, np.uint8).reshape(h, w)
                start[f, s, c] = pos
                shape[f, s, c] = (h, w)
                offset[f, s, c] = (ox, oy)
                advance[f, s, c] = font.getlength(ch)
                pixels.append(cov.reshape(-1))
                pos += cov.size
    return {"pixels": np.concatenate(pixels), "start": start,
            "shape": shape, "offset": offset, "advance": advance,
            "sizes": np.asarray(SIZES, np.int32),
            "faces": np.asarray(FACES), "charset": np.asarray(CHARSET)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    a = ap.parse_args()
    np.savez_compressed(a.out, **build())
    print(f"wrote {a.out} ({os.path.getsize(a.out)} bytes)")


if __name__ == "__main__":
    main()
