"""Generate plate_glyphs.npz: the plate OCR's characters, rasterised once
with PIL so that the trainers and the OCR domain gate need no PIL or font
files.

    python -m vcm_ts_tpu_torch.data.make_plate_glyphs [--out PATH]

The atlas holds the 36 characters of CHARSET in seven faces at the sizes
the JAX package's tools draw (22-33): first the four training faces of
tools/train_plate_ocr.py (TRAIN_FONTS: PIL's default face and DejaVu
Sans, Serif Bold and Sans Mono), then its three held-out faces
(HELDOUT_FONTS: DejaVu Sans Bold, Serif and Sans Mono Bold), which
tools/ocr_domain_gate.py draws. Faces are appended, so the training
faces' entries keep their values and their places in `pixels`.

Per glyph: its 8-bit coverage (PIL's anti-aliased mask, font.getmask2
with the left-ascender anchor), the offset of that mask from the pen
position, the pen advance (font.getlength), and the glyph's box in whole
pixels from the pen position (x0, y0, x1, y1): the box that PIL's string
layout unions into a text's bbox (font.getbbox). Per pair of characters:
the kerning that PIL's layout adds to the first one's advance, in 1/64
pixel. train_plate_ocr.render_text reads the first four items;
ocr_domain_gate.render_plate_font reads them all.

A glyph's box is read from PIL: its rows from font.getbbox(ch); its
columns from the mask's ink, where a column at the box's edge can hold no
ink. PIL unions the box with the pen's span, which hides the right edge
when it does not pass the advance; so the right edge is taken from a
text that ends in the glyph with a pen position that shows it (one of the
one- and two-character prefixes), else from the ink.

This script alone imports PIL; it raises where PIL or a face is missing.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..eval.ocr_native import CHARSET

DEJAVU = "/usr/share/fonts/truetype/dejavu"
FACES = ("default", "DejaVuSans.ttf", "DejaVuSerif-Bold.ttf",
         "DejaVuSansMono.ttf",
         # held out from training (tools/ocr_domain_gate.py)
         "DejaVuSans-Bold.ttf", "DejaVuSerif.ttf", "DejaVuSansMono-Bold.ttf")
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


def _pixel(x26: int) -> int:
    """FreeType's 26.6 to whole pixels, rounding half up (PIL's PIXEL)."""
    return ((x26 + 32) & -64) >> 6


def _q(font, text: str) -> int:
    return round(font.getlength(text) * 64)


def _right_edge(font, ch: str, ink_right: int) -> int:
    """The glyph's right box edge: from a text ending in `ch` whose bbox
    passes the pen's rounded end (then the glyph sets it), else the ink's
    right edge."""
    adv = _q(font, ch)
    for prefix in [""] + list(CHARSET) + [a + b for a in CHARSET
                                          for b in CHARSET]:
        text = prefix + ch
        end = _q(font, text)
        x1 = font.getbbox(text)[2]
        if x1 > _pixel(end):
            return x1 - _pixel(end - adv)
    return ink_right


def build() -> dict:
    """The atlas arrays: pixels (flat uint8 coverage), start / shape /
    offset (F, S, 36[, 2]) int, advance (F, S, 36) float32, box (F, S, 36,
    4) int32, kern (F, S, 36, 36) int32 (1/64 px)."""
    nf, ns, nc = len(FACES), len(SIZES), len(CHARSET)
    start = np.zeros((nf, ns, nc), np.int64)
    shape = np.zeros((nf, ns, nc, 2), np.int32)
    offset = np.zeros((nf, ns, nc, 2), np.int32)
    advance = np.zeros((nf, ns, nc), np.float32)
    box = np.zeros((nf, ns, nc, 4), np.int32)
    kern = np.zeros((nf, ns, nc, nc), np.int32)
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
                x0, y0, _, y1 = font.getbbox(ch)
                cols = np.nonzero(cov.any(0))[0]
                left = x0 if x0 < 0 else ox + int(cols.min())
                box[f, s, c] = (left, y0, _right_edge(
                    font, ch, ox + int(cols.max()) + 1), y1)
                for c2, ch2 in enumerate(CHARSET):
                    kern[f, s, c, c2] = (_q(font, ch + ch2) - _q(font, ch)
                                         - _q(font, ch2))
    return {"pixels": np.concatenate(pixels), "start": start,
            "shape": shape, "offset": offset, "advance": advance,
            "box": box, "kern": kern,
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
