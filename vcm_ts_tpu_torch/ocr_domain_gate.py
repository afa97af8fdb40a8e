"""Domain-shift gate for the plate OCR: the port's counterpart of the JAX
package's tools/ocr_domain_gate.py.

    python -m vcm_ts_tpu_torch.ocr_domain_gate [--n 64] \
        [--npz pretrained/plate_ocr.npz] [--seed 0] [--device cuda]

The trainer draws plates in four faces (PIL's default and three DejaVu
faces, train_plate_ocr.py). This gate scores a recognizer's weights on
plates unlike those:

- HELD-OUT FONTS: the three DejaVu faces the trainer never draws (Sans
  Bold, Serif, Sans Mono Bold): other glyph shapes, stroke widths and
  serifs;
- PERSPECTIVE: random 4-corner homography jitter (plates shot off-axis);
- PHOTOMETRICS: gaussian or motion blur, contrast and brightness swings,
  additive noise, a JPEG round trip;

and the two shifts together, beside the trainer's default face with no
augmentation. Per condition: exact match (whole plate) and symbol
accuracy (1 - CER, eval/text_metrics.py). The JSON keys, the random
draws and their order are the JAX tool's.

No PIL: the plates are laid out from the glyph atlas
data/plate_glyphs.npz (data/make_plate_glyphs.py, which rasterised the
seven faces with PIL), as PIL's ImageDraw.text lays out and draws a whole
string (render_plate_font). The distortions are train_plate_ocr's. The
crops are recognized on --device (cuda by default; it raises without a
card, --device cpu runs on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .eval.ocr_native import CHARSET, PlateOCRNative
from .eval.text_metrics import cer
from .train_plate_ocr import (_atlas, distort_perspective,
                              distort_photometric, random_text)
from .utils.device import resolve_device

DEFAULT_FACE = 0            # PIL's default face, the first training face
HELDOUT_FACES = (4, 5, 6)   # DejaVu Sans Bold, Serif, Sans Mono Bold


def held_out_fonts() -> list[int]:
    """The atlas faces the trainer never draws (train_plate_ocr.py draws
    faces 0-3)."""
    return list(HELDOUT_FACES)


def _pixel(x26: int) -> int:
    """26.6 fixed point to whole pixels, half up (FreeType's rounding)."""
    return ((x26 + 32) & -64) >> 6


def _over(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Coverage a over coverage b in 8 bits, as PIL joins overlapping
    glyphs: a + b - a b / 255, the product rounded as MULDIV255."""
    a, b = a.astype(np.int32), b.astype(np.int32)
    t = a * b + 128
    return (a + b - (((t >> 8) + t) >> 8)).astype(np.uint8)


def layout(text: str, face: int, size: int):
    """The text's layout as PIL's: the bbox (x0, y0, x1, y1) of
    font.getbbox(text) and, per glyph, its ink coverage and its top-left
    corner from the origin. Pen positions add each glyph's advance and
    its kerning with the next in 1/64 pixel; each glyph sits at its pen
    position rounded to a pixel."""
    a = _atlas()
    s = int(np.searchsorted(a["sizes"], size))
    codes = [CHARSET.index(ch) for ch in text]
    adv = [int(round(float(a["advance"][face, s, c]) * 64)) for c in codes]
    pen, glyphs, boxes = 0, [], []
    for i, c in enumerate(codes):
        px = _pixel(pen)
        h, w = (int(v) for v in a["shape"][face, s, c])
        ox, oy = (int(v) for v in a["offset"][face, s, c])
        st = int(a["start"][face, s, c])
        cov = a["pixels"][st:st + h * w].reshape(h, w)
        ys, xs = np.nonzero(cov)
        if ys.size:
            glyphs.append((px + ox + int(xs.min()), oy + int(ys.min()),
                           cov[ys.min():ys.max() + 1, xs.min():xs.max() + 1]))
        bx0, by0, bx1, by1 = (int(v) for v in a["box"][face, s, c])
        boxes.append((px + bx0, by0, px + bx1, by1))
        pen += adv[i]
        if i + 1 < len(codes):
            pen += int(a["kern"][face, s, c, codes[i + 1]])
    bbox = (min([0] + [b[0] for b in boxes]), min(b[1] for b in boxes),
            max([_pixel(pen)] + [b[2] for b in boxes]),
            max(b[3] for b in boxes))
    return bbox, glyphs


def render_plate_font(text: str, rng: np.random.Generator,
                      face: int | None) -> np.ndarray:
    """Like train_plate_ocr.render_plate but in an explicit atlas face
    (None: PIL's default face) and with NO training augmentation: the JAX
    tool's draws (size, margins, background, ink) and its image, the text
    drawn as ImageDraw.text draws it at (mx - x0, my - y0)."""
    size = int(rng.integers(22, 34))
    face = DEFAULT_FACE if face is None else face
    (x0, y0, x1, y1), glyphs = layout(text, face, size)
    tw, th = x1 - x0, y1 - y0
    mx, my = int(rng.integers(4, 10)), int(rng.integers(3, 7))
    bg = int(rng.integers(170, 256))
    fg = int(rng.integers(0, 70))
    cov = np.zeros((th + 2 * my, tw + 2 * mx), np.uint8)
    for gx, gy, g in glyphs:
        x, y = mx - x0 + gx, my - y0 + gy
        region = cov[y:y + g.shape[0], x:x + g.shape[1]]
        region[...] = _over(region, g[:region.shape[0], :region.shape[1]])
    img = np.floor(bg + (fg - bg) * cov.astype(np.float32) / 255 + 0.5)
    return img.clip(0, 255).astype(np.uint8)


def conditions() -> dict:
    """{name: make(text, rng) -> uint8 crop}: the JAX tool's five
    conditions, each drawing from rng in the tool's order."""
    fonts = held_out_fonts()

    def held(r):
        return fonts[int(r.integers(len(fonts)))]

    return {
        "train-font-clean": lambda t, r: render_plate_font(t, r, None),
        "heldout-fonts": lambda t, r: render_plate_font(t, r, held(r)),
        "perspective": lambda t, r: distort_perspective(
            render_plate_font(t, r, held(r)), r),
        "photometric": lambda t, r: distort_photometric(
            render_plate_font(t, r, held(r)), r),
        "perspective+photometric": lambda t, r: distort_photometric(
            distort_perspective(render_plate_font(t, r, held(r)), r), r),
    }


def condition_crops(make, n: int, seed: int = 0):
    """n texts and their crops, from a generator seeded afresh per
    condition (as the JAX tool draws)."""
    rng = np.random.default_rng(seed)
    texts, crops = [], []
    for _ in range(n):
        t = random_text(rng)
        texts.append(t)
        crops.append(make(t, rng))
    return texts, crops


def evaluate(npz: str, n: int, seed: int = 0, device="cuda") -> dict:
    device = resolve_device(device)
    ocr = PlateOCRNative.load(npz, device=device)
    report = {"npz": npz, "n_per_condition": n,
              "fonts": len(held_out_fonts())}
    for cond, make in conditions().items():
        texts, crops = condition_crops(make, n, seed)
        # raw uint8 gray, preprocessed on the device by recognize_crops
        preds = ocr.recognize_crops(
            [torch.from_numpy(c).to(device) for c in crops])
        exact = float(np.mean([p == t for p, t in zip(preds, texts)]))
        sym = float(np.mean([1.0 - min(cer(t, p), 1.0)
                             for p, t in zip(preds, texts)]))
        report[cond] = {"exact": round(exact, 4),
                        "symbol_acc": round(sym, 4),
                        "example": f"{texts[0]!r} -> {preds[0]!r}"}
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--npz", default=os.path.join("pretrained",
                                                  "plate_ocr.npz"))
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    report = evaluate(a.npz, a.n, a.seed, a.device)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
