"""Train the plate-OCR recognizer (CRNN-CTC) on synthetic plates: the
port's counterpart of the JAX package's tools/train_plate_ocr.py.

    python -m vcm_ts_tpu_torch.train_plate_ocr --out artifacts/plate_ocr.npz \
        [--steps 3000] [--batch 64] [--lr 1e-3] [--seed 0] [--device cuda] \
        [--compare pretrained/plate_ocr.npz]

Plates are drawn on the host with the JAX tool's random calls in its
order (a seed gives the tool's draws until a rasterised size differs by a
pixel; size-dependent draws such as the noise then part the streams),
without PIL: the text comes from the glyph atlas data/plate_glyphs.npz
(data/make_plate_glyphs.py, the tool's four training faces at its
sizes), laid out by the glyphs' advances; rotation, rescale, perspective
and the capture-chain degradations come from data/synth.py. The
recognizer is eval/ocr_native.PlateRecognizer from flax's default init;
the loss is optax.ctc_loss's (train/ctc.py: a deterministic
forward-backward route on the card), the optimizer
clip_by_global_norm(1.0) + adamw(lr, weight_decay=1e-4)
(train/optimizer.AdamW). nn.LSTM's input-side biases, which flax's cell
does not have, stay zero and out of the optimizer. The weights go to
--out in the flax-tree .npz that both packages' PlateOCRNative.load read;
nothing is written into pretrained/. --compare scores another .npz on
the same held-out plates.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time

import numpy as np
import torch

from .data import synth
from .eval.ocr_native import (CHARSET, IMG_H, WIDTH_BUCKETS, PlateOCRNative,
                              ctc_greedy_decode, encode_text,
                              preprocess_crop)
from .train.ctc import ctc_loss
from .train.detector_steps import (RunClock, optimizer_step,
                                   refuse_pretrained)
from .train.optimizer import AdamW
from .utils.device import set_codec_numerics, to_device

MAX_LEN = 9
# common plate shapes: L=letter, D=digit, plus fully random strings so the
# model never keys on a fixed grammar (the JAX tool's FORMATS)
FORMATS = ("LDDDLL", "LDDDLLDD", "DDDLLL", "LLDDDDL", "LLLDDDD", "DDDDLL",
           "RRRRR", "RRRRRR", "RRRRRRR", "RRRRRRRR")
GLYPHS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "plate_glyphs.npz")
N_TRAIN_FACES = 4  # the JAX tool's TRAIN_FONTS: PIL default + 3 DejaVu


def random_text(rng: np.random.Generator) -> str:
    fmt = FORMATS[rng.integers(len(FORMATS))]
    out = []
    for ch in fmt:
        if ch == "L":
            out.append(CHARSET[10 + rng.integers(26)])
        elif ch == "D":
            out.append(CHARSET[rng.integers(10)])
        else:
            out.append(CHARSET[rng.integers(len(CHARSET))])
    return "".join(out)


@functools.lru_cache(maxsize=1)
def _atlas() -> dict:
    with np.load(GLYPHS) as z:
        atlas = {k: z[k] for k in z.files}
    if str(atlas["charset"]) != CHARSET:
        raise ValueError(f"{GLYPHS}: charset mismatch")
    return atlas


def render_text(text: str, face: int, size: int):
    """The text's 8-bit coverage, cropped to its ink box (h, w) uint8:
    each glyph's mask placed at the rounded pen position plus its offset,
    the pen moved by the glyph's advance, overlaps taking the larger
    coverage."""
    a = _atlas()
    s = int(np.searchsorted(a["sizes"], size))
    placed, pen = [], 0.0
    for ch in text:
        c = CHARSET.index(ch)
        h, w = (int(v) for v in a["shape"][face, s, c])
        ox, oy = (int(v) for v in a["offset"][face, s, c])
        st = int(a["start"][face, s, c])
        cov = a["pixels"][st:st + h * w].reshape(h, w)
        ys, xs = np.nonzero(cov)
        if ys.size:  # the ink box of the glyph's mask
            cov = cov[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
            placed.append((int(round(pen)) + ox + xs.min(), oy + ys.min(),
                           cov))
        pen += float(a["advance"][face, s, c])
    x0 = min(x for x, _, _ in placed)
    y0 = min(y for _, y, _ in placed)
    x1 = max(x + c.shape[1] for x, _, c in placed)
    y1 = max(y + c.shape[0] for _, y, c in placed)
    out = np.zeros((y1 - y0, x1 - x0), np.uint8)
    for x, y, cov in placed:
        h, w = cov.shape
        region = out[y - y0:y - y0 + h, x - x0:x - x0 + w]
        np.maximum(region, cov, out=region)
    return out


def distort_perspective(img: np.ndarray, rng: np.random.Generator,
                        strength: float = 0.12) -> np.ndarray:
    """Random 4-corner homography jitter (plates shot off-axis)."""
    h, w = img.shape[:2]
    jx, jy = strength * w, strength * h
    src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
    dst = (src + rng.uniform(-1, 1, (4, 2)) * np.array([jx, jy])
           ).astype(np.float32)
    return synth.warp_perspective(img, synth.perspective_matrix(src, dst))


def distort_photometric(img: np.ndarray, rng: np.random.Generator
                        ) -> np.ndarray:
    """Blur (gaussian/motion) + contrast/brightness + noise + JPEG
    round-trip: the capture-chain artifacts real plate crops carry."""
    out = img.astype(np.float32)
    k = int(rng.choice([3, 5]))
    if rng.random() < 0.5:
        out = synth.gaussian_blur(out, k)
    else:
        out = synth.box_blur_h(out, k)
    out = out * float(rng.uniform(0.6, 1.2)) + float(rng.uniform(-30, 30))
    out += rng.normal(0, float(rng.uniform(4, 14)), out.shape)
    out = out.clip(0, 255).astype(np.uint8)
    return synth.jpeg_roundtrip(out, int(rng.integers(35, 80)))


def render_plate(text: str, rng: np.random.Generator,
                 augment: bool = True) -> np.ndarray:
    """One synthetic gray plate crop (uint8, random size and quality),
    drawn with the JAX tool's random calls in its order: size, face, the
    margins, background and ink levels, a rotation (p 0.7), a rescale, the
    photometrics, then with augment perspective and the capture chain at
    probability 0.5 each."""
    size = int(rng.integers(22, 34))
    face = int(rng.integers(N_TRAIN_FACES)) if augment else 0
    cov = render_text(text, face, size).astype(np.float32)
    th, tw = cov.shape
    mx, my = int(rng.integers(3, 12)), int(rng.integers(2, 8))
    bg = int(rng.integers(150, 256))
    fg = int(rng.integers(0, 90))
    img = np.full((th + 2 * my, tw + 2 * mx), float(bg), np.float32)
    img[my:my + th, mx:mx + tw] += (fg - bg) * cov / 255.0
    img = np.floor(img + 0.5).clip(0, 255).astype(np.uint8)
    if rng.random() < 0.7:
        img = synth.rotate_u8(img, float(rng.uniform(-4, 4)), bg)
    # random plate-crop scale (detector crops arrive at many sizes)
    scale = float(rng.uniform(0.5, 1.6))
    h, w = img.shape
    img = synth.resize_bilinear_u8(img, max(12, int(w * scale)),
                                   max(10, int(h * scale)))
    a = img.astype(np.float32)
    a = a * float(rng.uniform(0.75, 1.1)) + float(rng.uniform(-20, 20))
    a += rng.normal(0.0, float(rng.uniform(0, 12)), a.shape)
    a = a.clip(0, 255).astype(np.uint8)
    if augment:
        if rng.random() < 0.5:
            a = distort_perspective(a, rng,
                                    strength=float(rng.uniform(0.04, 0.14)))
        if rng.random() < 0.5:
            a = distort_photometric(a, rng)
    return a


def make_batch(batch: int, rng: np.random.Generator, width: int,
               texts: list[str] | None = None):
    """A batch at one width bucket: images (B, 32, width) in [-1, 1],
    labels (B, MAX_LEN) int32, label paddings (B, MAX_LEN), the texts."""
    images = np.zeros((batch, IMG_H, width), np.float32)
    labels = np.zeros((batch, MAX_LEN), np.int32)
    label_pad = np.ones((batch, MAX_LEN), np.float32)
    out_texts = []
    for i in range(batch):
        text = texts[i] if texts is not None else random_text(rng)
        out_texts.append(text)
        crop = preprocess_crop(torch.from_numpy(render_plate(text, rng)))
        crop = crop.numpy()
        images[i, :, :crop.shape[1]] = crop[:, :width]
        labels[i], label_pad[i] = encode_text(text, MAX_LEN)
    return images, labels, label_pad, out_texts


def freeze_input_bias(model: torch.nn.Module) -> torch.nn.Module:
    """nn.LSTM's bias_ih (zero; flax's cell has none) out of training."""
    for name, p in model.named_parameters():
        if ".bias_ih_" in name:
            p.requires_grad_(False)
    return model


def make_optimizer(model, lr: float) -> AdamW:
    return AdamW(model, lr, weight_decay=1e-4, grad_clip_norm=1.0)


def loss_fn(model, images, labels, label_pad) -> torch.Tensor:
    """Mean over the batch of optax.ctc_loss (the JAX tool's loss_fn)."""
    logits = model(images[:, None])
    return ctc_loss(logits, labels, label_pad).mean()


def make_step(model, opt):
    """One training step on host arrays -> the loss (a device scalar)."""
    dev = next(model.parameters()).device

    def step(images, labels, label_pad):
        x = to_device(torch.from_numpy(images), dev)
        loss = loss_fn(model, x, labels, label_pad)
        optimizer_step(model, opt, loss)
        return loss.detach()

    return step


def exact_match(ocr: PlateOCRNative, images, texts) -> float:
    pred = ctc_greedy_decode(ocr.logits(torch.from_numpy(images)).cpu()
                             .numpy())
    return float(np.mean([p == t for p, t in zip(pred, texts)]))


def train(steps: int, batch: int, lr: float, seed: int, out: str,
          device="cuda", log_every: int = 50, compare: str | None = None
          ) -> dict:
    refuse_pretrained(out)
    ocr = PlateOCRNative.init_random(seed, device)
    if ocr.device.type == "cuda":
        set_codec_numerics()
    model = freeze_input_bias(ocr.model).train()
    opt = make_optimizer(model, lr)
    step = make_step(model, opt)
    rng = np.random.default_rng(seed)
    width = WIDTH_BUCKETS[-1]
    clock = RunClock(ocr.device)
    losses = []
    t0 = time.perf_counter()
    for it in range(1, steps + 1):
        clock.synth_start()
        images, labels, label_pad, _ = make_batch(batch, rng, width)
        clock.synth_end()
        losses.append(clock.step(step, images, labels, label_pad))
        if it % log_every == 0 or it == steps:
            print(f"step {it}/{steps} loss {losses[-1]:.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    wall = time.perf_counter() - t0
    model.eval()
    # held-out exact match, on plates drawn after training as the tool does
    images, _, _, texts = make_batch(min(128, 4 * batch), rng, width)
    rec = {"trainer": "plate_ocr", "wall_s": wall, "loss_first": losses[0],
           "loss_last": losses[-1], "exact": exact_match(ocr, images, texts),
           **clock.record()}
    if compare:
        rec["compare"] = {"weights": compare, "exact": exact_match(
            PlateOCRNative.load(compare, device), images, texts)}
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    ocr.save(out)
    print(f"held-out exact match: {rec['exact']:.3f}; saved {out}",
          flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compare", default=None,
                    help="another .npz scored on the same held-out plates")
    a = ap.parse_args(argv)
    # the host's share is numpy in one Python loop; torch's CPU ops there
    # are small, and more threads only contend for the cores
    torch.set_num_threads(1)
    rec = train(a.steps, a.batch, a.lr, a.seed, a.out, a.device,
                compare=a.compare)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
