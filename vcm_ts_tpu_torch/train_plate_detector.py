"""Train the license-plate detector (YOLOv8 at nano scale, one class) on
synthetic traffic-like scenes: the port's counterpart of the JAX
package's tools/train_plate_detector.py.

    python -m vcm_ts_tpu_torch.train_plate_detector \
        --out artifacts/yolov8-lp.npz [--steps 1500] [--batch 8] \
        [--lr 2e-3] [--seed 0] [--device cuda] \
        [--compare pretrained/yolov8-lp.npz]

Scenes are drawn on the host with the JAX tool's random calls in its
order (data/synth.py in place of cv2; plates from
train_plate_ocr.render_plate).
Targets are FCOS-style centre sampling (`build_targets`, the tool's numpy
as it is). The model is eval/yolo_native.YOLOv8NativeDetector (width
0.25, depth 0.34, nc 1) from flax's default init, with its BatchNorm
tensors made parameters (train/losses.train_batch_norm_tensors): the JAX
tool differentiates and decays all four. The loss is the tool's (BCE on
classes, DFL on the two neighbouring bins, closed-form IoU, gains 0.5 /
1.5 / 7.5, over the positives); the optimizer clip_by_global_norm(5.0) +
adamw(warmup-cosine lr, weight_decay=5e-4). The .npz goes to --out in the
tool's format (both packages' YOLOv8NativeDetector.load read it); nothing
is written into pretrained/. --compare scores another .npz on the same
held-out scenes.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from .data import synth
from .eval.yolo_native import YOLOv8NativeDetector
from .ops import rowwise
from .train.detector_steps import (RunClock, optimizer_step,
                                   refuse_pretrained)
from .train.losses import train_batch_norm_tensors
from .train.optimizer import AdamW, warmup_cosine_decay_schedule
from .train_plate_ocr import random_text, render_plate
from .utils.device import set_codec_numerics, to_device
from .utils.weights import save_npz, yolo_npz_arrays

IMGSZ = 320
STRIDES = (8, 16, 32)
REG_MAX = 16
NANO = dict(width=0.25, depth=0.34, max_channels=1024)


# --------------------------------------------------------------------------
# scene composition
# --------------------------------------------------------------------------

def _background(rng: np.random.Generator, size: int) -> np.ndarray:
    """Procedural traffic-like scene: sky/road gradient + building/car
    rectangles + lane lines + sensor noise."""
    top = rng.integers(60, 200, 3)
    bot = rng.integers(30, 140, 3)
    t = np.linspace(0, 1, size)[:, None, None]
    img = (top[None, None] * (1 - t) + bot[None, None] * t).astype(np.float32)
    img = np.broadcast_to(img, (size, size, 3)).copy()
    for _ in range(int(rng.integers(3, 10))):  # blocks: buildings/cars
        x1, y1 = rng.integers(0, size - 20, 2)
        w, h = rng.integers(15, size // 2, 2)
        color = rng.integers(20, 230, 3).astype(np.float32)
        synth.fill_rect(img, (int(x1), int(y1)), (int(x1 + w), int(y1 + h)),
                        color)
    for _ in range(int(rng.integers(2, 6))):  # lane/edge lines
        p1 = tuple(int(v) for v in rng.integers(0, size, 2))
        p2 = tuple(int(v) for v in rng.integers(0, size, 2))
        c = float(rng.integers(0, 255))
        synth.draw_line(img, p1, p2, (c, c, c), int(rng.integers(1, 4)))
    img += rng.normal(0, rng.uniform(2, 10), img.shape)
    return img.clip(0, 255)


def _distractor(rng: np.random.Generator) -> np.ndarray:
    """Plate-shaped rectangle WITHOUT text: forces the model to key on
    text-ness, not on 'bright rectangle'."""
    w = int(rng.integers(30, 140))
    h = int(rng.integers(10, w // 2 + 11))
    bg = float(rng.integers(120, 255))
    img = np.full((h, w, 3), bg, np.float32)
    img += rng.normal(0, rng.uniform(0, 8), img.shape)
    if rng.random() < 0.5:  # border like a real plate
        img[:2] = img[-2:] = img[:, :2] = img[:, -2:] = rng.integers(0, 90)
    return img.clip(0, 255)


def compose_scene(rng: np.random.Generator, size: int = IMGSZ):
    """Returns (image float32 (size,size,3) in [0,255], boxes (K,4) xyxy)."""
    img = _background(rng, size)
    for _ in range(int(rng.integers(1, 4))):
        _paste(img, _distractor(rng), rng)
    boxes = []
    n_plates = int(rng.choice([0, 1, 1, 2, 2, 3]))
    for _ in range(n_plates):
        plate = render_plate(random_text(rng), rng).astype(np.float32)
        plate = np.repeat(plate[:, :, None], 3, axis=2)
        if rng.random() < 0.5:  # slight tint (eu-style blue strip absent)
            plate *= rng.uniform(0.85, 1.0, 3)
        # scale to a detectable on-canvas width
        tw = float(rng.uniform(36, 170))
        s = tw / plate.shape[1]
        nh = max(8, int(round(plate.shape[0] * s)))
        plate = synth.resize_area(plate, nh, int(tw))
        box = _paste(img, plate, rng, avoid=boxes)
        if box is not None:
            boxes.append(box)
    return img.clip(0, 255), np.asarray(boxes, np.float32).reshape(-1, 4)


def _paste(img, patch, rng, avoid=()):
    size = img.shape[0]
    ph, pw = patch.shape[:2]
    if ph >= size or pw >= size:
        return None
    for _ in range(10):
        x = int(rng.integers(0, size - pw))
        y = int(rng.integers(0, size - ph))
        box = (x, y, x + pw, y + ph)
        if all(_iou(box, b) < 0.1 for b in avoid):
            img[y:y + ph, x:x + pw] = patch
            return box
    return None


def _iou(a, b):
    ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = ((a[2] - a[0]) * (a[3] - a[1])
          + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / max(ua, 1e-9)


# --------------------------------------------------------------------------
# target assignment (host, FCOS-style center sampling)
# --------------------------------------------------------------------------

def build_targets(boxes: np.ndarray, size: int = IMGSZ,
                  strides=STRIDES, reg_max: int = REG_MAX,
                  center_radius: float = 1.5):
    """Dense per-scale targets for one image.

    Returns per scale: cls (H,W), ltrb (H,W,4) in feature units, mask
    (H,W). A cell is positive for a gt when its center lies inside the gt
    box, within center_radius cells of the gt center, and all four ltrb
    distances fit the DFL support [0, reg_max-1]. Smallest-area gt wins
    contested cells.
    """
    out = []
    for s in strides:
        g = size // s
        cls = np.zeros((g, g), np.float32)
        ltrb = np.zeros((g, g, 4), np.float32)
        mask = np.zeros((g, g), np.float32)
        best_area = np.full((g, g), np.inf, np.float32)
        cx = (np.arange(g) + 0.5) * s
        cy = (np.arange(g) + 0.5) * s
        CX, CY = np.meshgrid(cx, cy)
        for (x1, y1, x2, y2) in boxes:
            l = (CX - x1) / s  # noqa: E741
            t = (CY - y1) / s
            r = (x2 - CX) / s
            b = (y2 - CY) / s
            inside = (l > 0) & (t > 0) & (r > 0) & (b > 0)
            fits = np.maximum(np.maximum(l, r), np.maximum(t, b)) \
                <= reg_max - 1
            gcx, gcy = (x1 + x2) / 2, (y1 + y2) / 2
            near = (np.abs(CX - gcx) <= center_radius * s) & \
                   (np.abs(CY - gcy) <= center_radius * s)
            area = (x2 - x1) * (y2 - y1)
            sel = inside & fits & near & (area < best_area)
            best_area[sel] = area
            cls[sel] = 1.0
            mask[sel] = 1.0
            for i, v in enumerate((l, t, r, b)):
                ltrb[..., i][sel] = v[sel]
        out.append((cls, ltrb.clip(0, reg_max - 1 - 1e-3), mask))
    return out


def make_batch(batch: int, rng: np.random.Generator, size: int = IMGSZ):
    imgs = np.zeros((batch, size, size, 3), np.float32)
    targets = None
    gt_boxes = []
    for i in range(batch):
        img, boxes = compose_scene(rng, size)
        imgs[i] = img / 255.0
        gt_boxes.append(boxes)
        t = build_targets(boxes, size)
        if targets is None:
            targets = [[np.zeros((batch,) + a.shape, np.float32)
                        for a in scale] for scale in t]
        for si, scale in enumerate(t):
            for ai, a in enumerate(scale):
                targets[si][ai][i] = a
    return imgs, targets, gt_boxes


# --------------------------------------------------------------------------
# loss + train step
# --------------------------------------------------------------------------

def make_model(seed: int = 0, device="cuda") -> YOLOv8NativeDetector:
    """The nano detector from flax's default init, BatchNorm tensors
    trainable."""
    det = YOLOv8NativeDetector(nc=1, reg_max=REG_MAX, imgsz=IMGSZ,
                               device=device, **NANO).init(seed)
    return train_batch_norm_tensors(det)


def loss_fn(det: YOLOv8NativeDetector, imgs: torch.Tensor,
            targets) -> torch.Tensor:
    """The JAX tool's loss_fn: imgs (N, H, W, 3) in [0, 1], targets per
    scale (cls (N, g, g), ltrb (N, g, g, 4), mask (N, g, g))."""
    taps = det.backbone(imgs.permute(0, 3, 1, 2))
    outs = det.head([taps["3_deep"], taps["4_deep"], taps["5_deep"]])
    bins = torch.arange(REG_MAX, dtype=imgs.dtype, device=imgs.device)
    zero = imgs.new_zeros(())
    total_cls = total_dfl = total_iou = zero
    num_pos = zero + 1e-3
    for (box, cls), (cls_t, ltrb_t, mask) in zip(outs, targets):
        n, _, h, w = box.shape
        cls_lg = cls[:, 0]
        # optax.sigmoid_binary_cross_entropy
        bce = (-cls_t * F.logsigmoid(cls_lg)
               - (1.0 - cls_t) * F.logsigmoid(-cls_lg))
        total_cls = total_cls + bce.sum()
        num_pos = num_pos + mask.sum()
        # DFL: CE to the two adjacent integer bins of each distance
        lg = box.permute(0, 2, 3, 1).reshape(n, h, w, 4, REG_MAX)
        logp = torch.log_softmax(lg, dim=-1)
        tl = torch.floor(ltrb_t)
        wr = ltrb_t - tl
        tl_i = tl.long()
        tr_i = torch.clamp(tl_i + 1, max=REG_MAX - 1)
        lp_l = (logp * F.one_hot(tl_i, REG_MAX).to(logp.dtype)).sum(-1)
        lp_r = (logp * F.one_hot(tr_i, REG_MAX).to(logp.dtype)).sum(-1)
        dfl = -((1 - wr) * lp_l + wr * lp_r)
        total_dfl = total_dfl + (dfl.sum(-1) * mask).sum()
        # IoU on decoded ltrb (same cell center => closed-form overlap)
        d = torch.softmax(lg, dim=-1) @ bins
        iw = (torch.minimum(d[..., 0], ltrb_t[..., 0])
              + torch.minimum(d[..., 2], ltrb_t[..., 2]))
        ih = (torch.minimum(d[..., 1], ltrb_t[..., 1])
              + torch.minimum(d[..., 3], ltrb_t[..., 3]))
        inter = torch.maximum(iw, zero) * torch.maximum(ih, zero)
        a_p = (d[..., 0] + d[..., 2]) * (d[..., 1] + d[..., 3])
        a_t = ((ltrb_t[..., 0] + ltrb_t[..., 2])
               * (ltrb_t[..., 1] + ltrb_t[..., 3]))
        iou = inter / torch.maximum(a_p + a_t - inter, zero + 1e-9)
        total_iou = total_iou + ((1 - iou) * mask).sum()
    # v8 gain ratios: box 7.5, cls 0.5, dfl 1.5 (relative emphasis)
    return (0.5 * total_cls + 1.5 * total_dfl + 7.5 * total_iou) / num_pos


def make_optimizer(det, lr: float, steps: int) -> AdamW:
    sched = warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=min(100, steps // 10 + 1), decay_steps=steps,
        end_value=lr * 0.05)
    return AdamW(det, sched, weight_decay=5e-4, grad_clip_norm=5.0)


def make_step(det: YOLOv8NativeDetector, opt):
    """One training step on host arrays -> the loss (a device scalar).
    The convs take the whole batch (ops/rowwise.whole_batch)."""
    dev = det.device

    def step(imgs, targets):
        x = to_device(torch.from_numpy(imgs), dev)
        tg = [[to_device(torch.from_numpy(a), dev) for a in scale]
              for scale in targets]
        with rowwise.whole_batch():
            loss = loss_fn(det, x, tg)
            optimizer_step(det, opt, loss)
        return loss.detach()

    return step


# --------------------------------------------------------------------------
# evaluation
# --------------------------------------------------------------------------

def held_out(seed: int, n_scenes: int = 48) -> list:
    """The held-out scenes the tool scores on: n_scenes drawn from seed."""
    rng = np.random.default_rng(seed)
    return [compose_scene(rng) for _ in range(n_scenes)]


def evaluate(det, scenes, conf: float = 0.25, iou_thr: float = 0.5):
    """Precision/recall at IoU 0.5 of det.detect over (image, boxes)
    scenes."""
    tp = fp = fn = 0
    for img, gts in scenes:
        boxes, scores, _ = det.detect(img.astype(np.uint8), conf=conf)
        used = np.zeros(len(gts), bool)
        for b in boxes:
            ious = [_iou(b, g) if not used[i] else 0.0
                    for i, g in enumerate(gts)]
            if ious and max(ious) >= iou_thr:
                used[int(np.argmax(ious))] = True
                tp += 1
            else:
                fp += 1
        fn += int((~used).sum())
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    return prec, rec


# --------------------------------------------------------------------------
# export
# --------------------------------------------------------------------------

def export_npz(det: YOLOv8NativeDetector, out: str):
    """The JAX tool's key and meta format: YOLOv8NativeDetector.load reads
    it in either package."""
    meta = dict(nc=1, reg_max=REG_MAX, imgsz=IMGSZ, names=["plate"],
                trained="in-repo vcm_ts_tpu_torch/train_plate_detector.py",
                **NANO)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_npz(out, yolo_npz_arrays(det.backbone, det.head), meta)


def train(steps: int, batch: int, lr: float, seed: int, out: str,
          device="cuda", log_every: int = 50, compare: str | None = None
          ) -> dict:
    refuse_pretrained(out)
    det = make_model(seed, device)
    if det.device.type == "cuda":
        set_codec_numerics()
    rng = np.random.default_rng(seed)
    opt = make_optimizer(det, lr, steps)
    step = make_step(det, opt)
    clock = RunClock(det.device)
    losses = []
    t0 = time.perf_counter()
    for it in range(1, steps + 1):
        clock.synth_start()
        imgs, targets, _ = make_batch(batch, rng)
        clock.synth_end()
        losses.append(clock.step(step, imgs, targets))
        if it % log_every == 0 or it == steps:
            print(f"step {it}/{steps} loss {losses[-1]:.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    wall = time.perf_counter() - t0
    scenes = held_out(seed + 1)
    prec, rec = evaluate(det, scenes)
    result = {"trainer": "plate_detector", "wall_s": wall,
              "loss_first": losses[0], "loss_last": losses[-1],
              "precision": prec, "recall": rec, **clock.record()}
    if compare:
        p2, r2 = evaluate(YOLOv8NativeDetector.load(compare, device=device),
                          scenes)
        result["compare"] = {"weights": compare, "precision": p2,
                             "recall": r2}
    export_npz(det, out)
    print(f"held-out precision {prec:.3f} recall {rec:.3f}; saved {out}",
          flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compare", default=None,
                    help="another .npz scored on the same held-out scenes")
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
