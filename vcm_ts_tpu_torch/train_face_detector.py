"""Train the MTCNN face-detector cascade (P/R/O-Net) on synthetic face
composites: the port's counterpart of the JAX package's
tools/train_face_detector.py.

    python -m vcm_ts_tpu_torch.train_face_detector \
        --out artifacts/mtcnn.npz [--steps 1200] [--batch-scenes 4] \
        [--lr 1e-3] [--seed 0] [--device cuda] \
        [--compare pretrained/mtcnn.npz]

Faces (ellipse head, hair cap, eyes, brows, nose, mouth, a rotation and
photometrics) are drawn on the host with data/synth.py in place of cv2,
with the JAX tool's random calls in its order, and pasted into the plate
trainer's traffic-like backgrounds beside featureless skin-tone blobs.
Each net trains in turn, from one generator, on IoU-stratified square
crops at its input size (12 / 24 / 48: positive IoU >= 0.65, part >= 0.4,
negative < 0.3), padded to batch_scenes x 8 rows with label -2, with the
tool's loss (2-class CE on positives and negatives, 0.5 x L2 box
regression on positives and parts), clip_by_global_norm(5.0) and
adamw(lr). The nets start from flax's default init
(eval/mtcnn_native.MTCNNNativeDetector.init). The .npz goes to --out in
the tool's "<net>.<torch name>" format; nothing is written into
pretrained/. --compare scores another .npz on the same held-out scenes.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .data import synth
from .eval.mtcnn_native import MTCNNNativeDetector
from .train.detector_steps import (RunClock, optimizer_step,
                                   refuse_pretrained)
from .train.optimizer import AdamW
from .train_plate_detector import _background, _iou
from .utils.device import set_codec_numerics, to_device
from .utils.weights import mtcnn_npz_arrays, save_npz

CROP_SIZES = {"pnet": 12, "rnet": 24, "onet": 48}


# --------------------------------------------------------------------------
# synthetic faces
# --------------------------------------------------------------------------

def render_face(rng: np.random.Generator, size: int) -> np.ndarray:
    """One procedural face patch (size, size, 4): RGB + alpha mask."""
    s = size
    img = np.zeros((s, s, 3), np.float32)
    alpha = np.zeros((s, s), np.float32)
    skin = np.array([rng.uniform(150, 240), rng.uniform(110, 190),
                     rng.uniform(90, 170)], np.float32)
    cx, cy = s // 2, s // 2
    ax, ay = int(s * rng.uniform(0.32, 0.42)), int(s * rng.uniform(0.42, 0.5))
    synth.fill_ellipse(img, (cx, cy), (ax, ay), 0, 360, skin)
    synth.fill_ellipse(alpha, (cx, cy), (ax, ay), 0, 360, 1.0)
    # hair cap
    hair = rng.uniform(10, 90, 3)
    synth.fill_ellipse(img, (cx, cy - int(ay * 0.55)),
                       (ax, int(ay * 0.55)), 180, 360, hair)
    # eyes
    ey = cy - int(ay * rng.uniform(0.1, 0.25))
    ex = int(ax * rng.uniform(0.35, 0.55))
    er = max(1, int(s * rng.uniform(0.04, 0.07)))
    for sx in (-1, 1):
        synth.fill_circle(img, (cx + sx * ex, ey), er + 1, (250, 250, 250))
        synth.fill_circle(img, (cx + sx * ex, ey), max(1, int(er * 0.6)),
                          (20, 20, 40))
        # brow
        synth.draw_line(
            img, (cx + sx * ex - er, ey - 2 * er),
            (cx + sx * ex + er, ey - 2 * er - int(sx * rng.integers(0, 3))),
            hair, max(1, s // 40))
    # nose + mouth
    synth.draw_line(img, (cx, ey + er), (cx - er // 2, cy + int(ay * 0.15)),
                    skin * 0.75, max(1, s // 48))
    mw = int(ax * rng.uniform(0.4, 0.7))
    my = cy + int(ay * rng.uniform(0.4, 0.55))
    synth.fill_ellipse(img, (cx, my),
                       (mw, max(1, int(er * rng.uniform(0.6, 1.4)))), 0, 180,
                       (120, 40, 50))
    # pose/photometrics
    ang = float(rng.uniform(-18, 18))
    m = synth.rotation_matrix((cx, cy), ang, 1.0)
    img = synth.warp_affine(img, m, (s, s))
    alpha = synth.warp_affine(alpha, m, (s, s))
    img = img * rng.uniform(0.7, 1.15) + rng.normal(0, 6, img.shape)
    return np.dstack([img.clip(0, 255), alpha])


def compose_scene(rng: np.random.Generator, size: int = 320):
    """(image float32 [0,255], face boxes (K,4) xyxy)."""
    img = _background(rng, size)
    # distractors: featureless skin-tone blobs
    for _ in range(int(rng.integers(1, 4))):
        bs = int(rng.integers(20, 90))
        rgb = np.zeros((bs, bs, 3), np.float32)
        a = np.zeros((bs, bs), np.float32)
        skin = (float(rng.uniform(150, 240)), float(rng.uniform(110, 190)),
                float(rng.uniform(90, 170)))
        axes = (int(bs * 0.4), int(bs * 0.48))
        synth.fill_ellipse(rgb, (bs // 2, bs // 2), axes, 0, 360, skin)
        synth.fill_ellipse(a, (bs // 2, bs // 2), axes, 0, 360, 1.0)
        _paste_rgba(img, np.dstack([rgb, a]), rng)
    boxes = []
    for _ in range(int(rng.choice([0, 1, 1, 2, 2, 3]))):
        fs = int(rng.integers(28, 150))
        face = render_face(rng, fs)
        box = _paste_rgba(img, face, rng, avoid=boxes)
        if box is not None:
            boxes.append(box)
    return img.clip(0, 255), np.asarray(boxes, np.float32).reshape(-1, 4)


def _paste_rgba(img, patch, rng, avoid=()):
    size = img.shape[0]
    ph, pw = patch.shape[:2]
    if ph >= size or pw >= size:
        return None
    for _ in range(10):
        x = int(rng.integers(0, size - pw))
        y = int(rng.integers(0, size - ph))
        box = (x, y, x + pw, y + ph)
        if all(_iou(box, b) < 0.1 for b in avoid):
            synth.paste_rgba(img, patch, x, y)
            return box
    return None


# --------------------------------------------------------------------------
# crop sampling (pos / part / neg, square, MTCNN reg targets)
# --------------------------------------------------------------------------

def sample_crops(rng: np.random.Generator, n_scenes: int, crop_size: int,
                 per_scene: int = 8):
    """Returns (crops (N,s,s,3) normalized, labels (N,) {1,0,-1}=pos/neg/
    part, regs (N,4))."""
    crops, labels, regs = [], [], []
    for _ in range(n_scenes):
        img, gts = compose_scene(rng)
        H, W = img.shape[:2]
        want_pos = per_scene // 2 if len(gts) else 0
        got = 0
        # positives/parts: jitter around gt squares
        attempts = 0
        while got < want_pos and attempts < 50:
            attempts += 1
            g = gts[rng.integers(len(gts))]
            side0 = max(g[2] - g[0], g[3] - g[1])
            side = side0 * rng.uniform(0.8, 1.25)
            cx = (g[0] + g[2]) / 2 + rng.uniform(-0.25, 0.25) * side0
            cy = (g[1] + g[3]) / 2 + rng.uniform(-0.25, 0.25) * side0
            x1, y1 = cx - side / 2, cy - side / 2
            x2, y2 = x1 + side, y1 + side
            if x1 < 0 or y1 < 0 or x2 > W or y2 > H:
                continue
            iou = max(_iou((x1, y1, x2, y2), g2) for g2 in gts)
            if iou < 0.4:
                continue
            lab = 1 if iou >= 0.65 else -1
            crop = synth.resize_area(img[int(y1):int(y2), int(x1):int(x2)],
                                     crop_size, crop_size)
            reg = np.array([(g[0] - x1) / side, (g[1] - y1) / side,
                            (g[2] - x2) / side, (g[3] - y2) / side],
                           np.float32)
            crops.append(crop)
            labels.append(lab)
            regs.append(reg)
            got += 1
        # negatives: random squares with low IoU (half near-miss)
        neg = 0
        attempts = 0
        while neg < per_scene - got and attempts < 80:
            attempts += 1
            if len(gts) and rng.random() < 0.4:  # near-miss around a face
                g = gts[rng.integers(len(gts))]
                side = max(g[2] - g[0], g[3] - g[1]) * rng.uniform(0.5, 2.0)
                cx = (g[0] + g[2]) / 2 + rng.uniform(-1.2, 1.2) * side
                cy = (g[1] + g[3]) / 2 + rng.uniform(-1.2, 1.2) * side
                x1, y1 = cx - side / 2, cy - side / 2
            else:
                side = rng.uniform(14, min(H, W) * 0.6)
                x1 = rng.uniform(0, W - side)
                y1 = rng.uniform(0, H - side)
            x2, y2 = x1 + side, y1 + side
            if x1 < 0 or y1 < 0 or x2 > W or y2 > H:
                continue
            if len(gts) and max(_iou((x1, y1, x2, y2), g) for g in gts) \
                    >= 0.3:
                continue
            crop = synth.resize_area(img[int(y1):int(y2), int(x1):int(x2)],
                                     crop_size, crop_size)
            crops.append(crop)
            labels.append(0)
            regs.append(np.zeros(4, np.float32))
            neg += 1
    crops = (np.stack(crops).astype(np.float32) - 127.5) * 0.0078125
    return crops, np.asarray(labels, np.int32), np.stack(regs)


def pad_batch(crops, labels, regs, fixed: int):
    """Trim or pad (label -2, zero crops) a sample_crops draw to `fixed`
    rows: the JAX tool's static batch."""
    n, size = crops.shape[0], crops.shape[1]
    if n >= fixed:
        return crops[:fixed], labels[:fixed], regs[:fixed]
    pad = fixed - n
    return (np.concatenate([crops, np.zeros((pad, size, size, 3),
                                            np.float32)]),
            np.concatenate([labels, np.full(pad, -2, np.int32)]),
            np.concatenate([regs, np.zeros((pad, 4), np.float32)]))


# --------------------------------------------------------------------------
# per-net training
# --------------------------------------------------------------------------

def loss_fn(net, crops: torch.Tensor, labels: torch.Tensor,
            regs: torch.Tensor) -> torch.Tensor:
    """The JAX tool's loss_fn (tools/train_face_detector.py:223-239):
    crops (N, s, s, 3) normalised, labels (N,) {1, 0, -1, -2 pad}."""
    outs = net(crops.permute(0, 3, 1, 2))
    reg, probs = outs[0], outs[-1]  # ONet returns (reg, lmk, probs)
    if probs.dim() == 4:  # PNet dense map on 12x12 input -> (N,2,1,1)
        probs = probs[:, :, 0, 0]
        reg = reg[:, :, 0, 0]
    is_pos = labels == 1
    is_neg = labels == 0
    is_reg = is_pos | (labels == -1)  # pos + part (label -2 = pad)
    one = torch.ones_like(probs[:, 0])
    ce = -torch.log(torch.where(is_pos, probs[:, 1],
                                torch.where(is_neg, probs[:, 0], one))
                    + 1e-9)
    cls_mask = (is_pos | is_neg).to(ce.dtype)
    cls_loss = (ce * cls_mask).sum() / torch.clamp(cls_mask.sum(), min=1)
    reg_mask = is_reg.to(ce.dtype)
    reg_loss = (((reg - regs) ** 2).sum(-1) * reg_mask).sum() / \
        torch.clamp(reg_mask.sum(), min=1)
    return cls_loss + 0.5 * reg_loss


def make_step(net, opt):
    """One training step on host arrays -> the loss (a device scalar)."""
    dev = next(net.parameters()).device

    def step(crops, labels, regs):
        loss = loss_fn(net, to_device(torch.from_numpy(crops), dev),
                       to_device(torch.from_numpy(labels), dev),
                       to_device(torch.from_numpy(regs), dev))
        optimizer_step(net, opt, loss)
        return loss.detach()

    return step


def make_optimizer(net, lr: float) -> AdamW:
    return AdamW(net, lr, weight_decay=1e-4, grad_clip_norm=5.0)


def train_net(net_name: str, net, steps: int, batch_scenes: int, lr: float,
              rng: np.random.Generator, clock: RunClock,
              log_every: int = 50) -> list:
    """Train one net in place; returns its losses."""
    size = CROP_SIZES[net_name]
    step = make_step(net, make_optimizer(net, lr))
    fixed = batch_scenes * 8
    losses = []
    t0 = time.perf_counter()
    for it in range(1, steps + 1):
        clock.synth_start()
        batch = pad_batch(*sample_crops(rng, batch_scenes, size), fixed)
        clock.synth_end()
        losses.append(clock.step(step, *batch))
        if it % log_every == 0 or it == steps:
            print(f"[{net_name}] step {it}/{steps} loss {losses[-1]:.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    return losses


def held_out(seed: int, n_scenes: int = 32) -> list:
    """The held-out scenes the tool scores on: n_scenes drawn from seed."""
    rng = np.random.default_rng(seed)
    return [compose_scene(rng) for _ in range(n_scenes)]


def evaluate(det, scenes, iou_thr: float = 0.5):
    """The cascade's precision and recall over (image, boxes) scenes."""
    tp = fp = fn = 0
    for img, gts in scenes:
        boxes, scores = det.detect(img.astype(np.uint8))
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
    return tp / max(tp + fp, 1), tp / max(tp + fn, 1)


def export_npz(det: MTCNNNativeDetector, out: str):
    """The JAX tool's key format: '<net>.<torch name>'."""
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_npz(out, mtcnn_npz_arrays({n: getattr(det, n)
                                    for n in ("pnet", "rnet", "onet")}),
             {"format": "mtcnn-v1",
              "trained": "in-repo vcm_ts_tpu_torch/train_face_detector.py"})


def train(steps: int, batch_scenes: int, lr: float, seed: int, out: str,
          device="cuda", compare: str | None = None) -> dict:
    refuse_pretrained(out)
    det = MTCNNNativeDetector(device=device).init(seed)
    if det.device.type == "cuda":
        set_codec_numerics()
    rng = np.random.default_rng(seed)
    clock = RunClock(det.device)
    losses = {}
    t0 = time.perf_counter()
    for net_name in ("pnet", "rnet", "onet"):
        losses[net_name] = train_net(net_name, getattr(det, net_name), steps,
                                     batch_scenes, lr, rng, clock)
    wall = time.perf_counter() - t0
    scenes = held_out(seed + 1)
    prec, rec = evaluate(det, scenes)
    result = {"trainer": "face_detector", "wall_s": wall,
              "loss_first": {k: v[0] for k, v in losses.items()},
              "loss_last": {k: v[-1] for k, v in losses.items()},
              "precision": prec, "recall": rec, **clock.record()}
    if compare:
        p2, r2 = evaluate(MTCNNNativeDetector.load(compare, device=device),
                          scenes)
        result["compare"] = {"weights": compare, "precision": p2,
                             "recall": r2}
    export_npz(det, out)
    print(f"held-out cascade precision {prec:.3f} recall {rec:.3f}; saved "
          f"{out}", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch-scenes", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compare", default=None,
                    help="another .npz scored on the same held-out scenes")
    a = ap.parse_args(argv)
    # the host's share is numpy in one Python loop; torch's CPU ops there
    # are small, and more threads only contend for the cores
    torch.set_num_threads(1)
    rec = train(a.steps, a.batch_scenes, a.lr, a.seed, a.out, a.device,
                compare=a.compare)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
