"""Native Faster-RCNN (resnet50-FPN v2) inference, the OD-mAP eval detector
of the Faster-RCNN perceptual-loss families (the port's copy of
vcm_ts_tpu/eval/rcnn_native.py).

The ResNet-50 body and the FPN v2 are the perceptual loss's
(train/losses.py). This module adds the RPN head, the multi-level anchors,
proposal decoding, filtering and NMS, multi-scale RoIAlign (aligned=False,
sampling ratio 2), the conv-FC box head and the per-class post-processing
of torchvision's fasterrcnn_resnet50_fpn_v2 at inference. The modules carry
torchvision's key names, so
pretrained/fasterrcnn_resnet50_fpn_v2_coco-dd69338a.pth loads with
strict=True into the whole detector; its head structure (norm layers in
the RPN head, the box head's conv count and width, the class count) is
read from the state dict (`introspect`), and another layout fails the
strict load instead of loading wrongly.

Where it runs, as in the JAX package: the networks and RoIAlign (torch
indexing, the JAX package's gather form) on the device; anchors, proposal
top-k, box decoding, NMS and the class loop on the host in numpy. One pull
brings the RPN's outputs to the host and one the box head's, so a frame
costs two pulls (`pulls` counts them). The resize of the preprocessing is
ops/cv_resize.resize_linear_u8 on the device (cv2.resize's INTER_LINEAR).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cv_resize import resize_linear_u8
from ..train.losses import FPN, FrozenBatchNorm, ResNet50Body
from ..utils.device import resolve_device
from ..utils.weights import load_torch_state_dict
from .yolo_native import nms

# level strides of the FPN maps ["0","1","2","3","pool"]
STRIDES = (4, 8, 16, 32, 64)
ANCHOR_SIZES = (32, 64, 128, 256, 512)
ASPECT_RATIOS = (0.5, 1.0, 2.0)
BBOX_XFORM_CLIP = math.log(1000.0 / 16)
LEVELS = ("0", "1", "2", "3", "pool")


# --------------------------------------------------------------- modules
class RPNHead(nn.Module):
    """torchvision RPNHead (v2: `conv` a Sequential of Conv2dNormActivation
    blocks, "i.0" the conv, "i.1" the optional norm)."""

    def __init__(self, channels: int = 256, depth: int = 2,
                 norm: bool = False):
        super().__init__()
        self.conv = nn.Sequential(*[
            nn.Sequential(nn.Conv2d(channels, channels, 3, padding=1,
                                    bias=not norm),
                          *([FrozenBatchNorm(channels)] if norm else []))
            for _ in range(depth)])
        self.cls_logits = nn.Conv2d(channels, len(ASPECT_RATIOS), 1)
        self.bbox_pred = nn.Conv2d(channels, len(ASPECT_RATIOS) * 4, 1)

    def forward(self, f):
        for blk in self.conv:
            f = F.relu(blk(f))
        return self.cls_logits(f), self.bbox_pred(f)


class BoxHead(nn.Module):
    """torchvision FastRCNNConvFCHead: children "0".."box_convs-1" conv +
    norm blocks, a Flatten (no parameters), then the linear layer
    ("box_convs + 1")."""

    def __init__(self, channels: int = 256, box_convs: int = 4,
                 box_fc: int = 1024):
        super().__init__()
        self.box_convs = box_convs
        for i in range(box_convs):
            self.add_module(str(i), nn.Sequential(
                nn.Conv2d(channels, channels, 3, padding=1, bias=False),
                FrozenBatchNorm(channels)))
        self.add_module(str(box_convs + 1), nn.Linear(channels * 49, box_fc))

    def forward(self, x):  # (N, 256, 7, 7)
        for i in range(self.box_convs):
            x = F.relu(self._modules[str(i)](x))
        # torchvision flattens NCHW: (C, H, W) order
        return F.relu(self._modules[str(self.box_convs + 1)](x.flatten(1)))


class BoxPredictor(nn.Module):
    def __init__(self, box_fc: int, num_classes: int):
        super().__init__()
        self.cls_score = nn.Linear(box_fc, num_classes)
        self.bbox_pred = nn.Linear(box_fc, num_classes * 4)

    def forward(self, x):
        return torch.softmax(self.cls_score(x), dim=-1), self.bbox_pred(x)


class _Node(nn.Module):
    """A named container (backbone, rpn, roi_heads)."""

    def __init__(self, **children):
        super().__init__()
        for k, v in children.items():
            self.add_module(k, v)


# ----------------------------------------------------- anchors, box math
def cell_anchors(size, ratios=ASPECT_RATIOS):
    """torchvision AnchorGenerator.generate_anchors (rounded base)."""
    r = np.asarray(ratios, np.float64)
    h_ratios = np.sqrt(r)
    w_ratios = 1.0 / h_ratios
    ws = w_ratios * size
    hs = h_ratios * size
    base = np.stack([-ws, -hs, ws, hs], axis=1) / 2
    return np.round(base).astype(np.float32)


def level_anchors(h, w, stride, size):
    """All anchors of one feature level, (H*W*A, 4) xyxy."""
    base = cell_anchors(size)
    sx = np.arange(w, dtype=np.float32) * stride
    sy = np.arange(h, dtype=np.float32) * stride
    shift_x, shift_y = np.meshgrid(sx, sy)
    shifts = np.stack([shift_x, shift_y, shift_x, shift_y],
                      axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def decode_boxes(deltas, anchors, weights=(1.0, 1.0, 1.0, 1.0)):
    """torchvision BoxCoder.decode_single."""
    wx, wy, ww, wh = weights
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = anchors[:, 0] + 0.5 * aw
    ay = anchors[:, 1] + 0.5 * ah
    dx, dy, dw, dh = (deltas[:, 0] / wx, deltas[:, 1] / wy,
                      np.minimum(deltas[:, 2] / ww, BBOX_XFORM_CLIP),
                      np.minimum(deltas[:, 3] / wh, BBOX_XFORM_CLIP))
    cx = dx * aw + ax
    cy = dy * ah + ay
    pw = np.exp(dw) * aw
    ph = np.exp(dh) * ah
    return np.stack([cx - 0.5 * pw, cy - 0.5 * ph,
                     cx + 0.5 * pw, cy + 0.5 * ph], axis=1)


def clip_boxes(boxes, h, w):
    out = boxes.copy()
    out[:, [0, 2]] = out[:, [0, 2]].clip(0, w)
    out[:, [1, 3]] = out[:, [1, 3]].clip(0, h)
    return out


def batched_nms(boxes, scores, idxs, iou_thres):
    """Category-aware NMS by the coordinate-offset trick (torchvision
    semantics); kept indices by descending score."""
    if boxes.shape[0] == 0:
        return np.zeros((0,), np.int64)
    off = idxs.astype(np.float32) * (boxes.max() + 1.0)
    return nms(boxes + off[:, None], scores, iou_thres, max_det=10 ** 9)


def roi_align(feat, rois, spatial_scale, out=7, ratio=2):
    """feat (C, H, W) tensor, rois (N, 4) image-coordinate xyxy numpy ->
    (N, C, out, out) on feat's device. aligned=False: each roi's extent is
    at least one feature unit; per output bin `ratio` x `ratio` bilinear
    samples, averaged; samples outside the map count 0."""
    _, H, W = feat.shape
    r = rois * spatial_scale
    x1, y1 = r[:, 0], r[:, 1]
    bw = np.maximum(r[:, 2] - x1, 1.0) / out
    bh = np.maximum(r[:, 3] - y1, 1.0) / out
    g = (np.arange(out * ratio, dtype=np.float32) + 0.5) / ratio
    xs = x1[:, None] + g[None] * bw[:, None]   # (N, out*ratio)
    ys = y1[:, None] + g[None] * bh[:, None]

    def sample(coords, size):
        valid = (coords > -1.0) & (coords < size)
        c = coords.clip(0, size - 1)
        lo = np.floor(c)
        frac = c - lo
        return lo.astype(np.int64), frac.astype(np.float32), valid

    xlo, xf, xv = sample(xs, W)
    ylo, yf, yv = sample(ys, H)
    xhi = np.minimum(xlo + 1, W - 1)
    yhi = np.minimum(ylo + 1, H - 1)

    dev = feat.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    fx = feat.permute(1, 2, 0)  # (H, W, C)
    ylo, yhi, xlo, xhi = t(ylo), t(yhi), t(xlo), t(xhi)
    # (N, S)[:, :, None] x (N, S)[:, None, :] -> the (N, S, S) sample grid
    v00 = fx[ylo[:, :, None], xlo[:, None, :]]
    v01 = fx[ylo[:, :, None], xhi[:, None, :]]
    v10 = fx[yhi[:, :, None], xlo[:, None, :]]
    v11 = fx[yhi[:, :, None], xhi[:, None, :]]
    wy = t(yf)[:, :, None, None]
    wx = t(xf)[:, None, :, None]
    val = ((1 - wy) * (1 - wx) * v00 + (1 - wy) * wx * v01
           + wy * (1 - wx) * v10 + wy * wx * v11)
    mask = (t(yv)[:, :, None] & t(xv)[:, None, :])[..., None]
    val = torch.where(mask, val, val.new_zeros(()))
    n, s = val.shape[0], out * ratio
    val = val.reshape(n, out, ratio, s, -1).mean(dim=2)
    val = val.reshape(n, out, out, ratio, -1).mean(dim=3)
    return val.permute(0, 3, 1, 2)


def map_levels(rois, k0=4, kmin=2, kmax=5, canonical=224):
    """torchvision LevelMapper: FPN level per roi (0..3 into "0".."3")."""
    area = np.maximum(rois[:, 2] - rois[:, 0], 0) * np.maximum(
        rois[:, 3] - rois[:, 1], 0)
    k = np.floor(k0 + np.log2(np.sqrt(area) / canonical + 1e-6))
    return (np.clip(k, kmin, kmax) - kmin).astype(np.int64)


# ---------------------------------------------------------- the detector
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _empty():
    return {"boxes": np.zeros((0, 4), np.float32),
            "labels": np.zeros((0,), np.int64),
            "scores": np.zeros((0,), np.float32)}


class FasterRCNNNativeDetector(nn.Module):
    """fasterrcnn_resnet50_fpn_v2 inference on one device. Thresholds and
    sizes follow torchvision's eval defaults; min/max size are the knobs
    the eval detector sets to 1088/1920 (eval/detector.py)."""

    def __init__(self, num_classes=91, rpn_depth=2, rpn_norm=False,
                 box_convs=4, box_fc=1024, min_size=800, max_size=1333,
                 rpn_pre_nms=1000, rpn_post_nms=1000, rpn_nms_thresh=0.7,
                 score_thresh=0.05, nms_thresh=0.5, detections=100,
                 device="cuda"):
        super().__init__()
        self.cfg = dict(num_classes=num_classes, min_size=min_size,
                        max_size=max_size, rpn_pre_nms=rpn_pre_nms,
                        rpn_post_nms=rpn_post_nms,
                        rpn_nms_thresh=rpn_nms_thresh,
                        score_thresh=score_thresh, nms_thresh=nms_thresh,
                        detections=detections)
        self.backbone = _Node(body=ResNet50Body(), fpn=FPN())
        self.rpn = _Node(head=RPNHead(256, rpn_depth, rpn_norm))
        self.roi_heads = _Node(
            box_head=BoxHead(256, box_convs, box_fc),
            box_predictor=BoxPredictor(box_fc, num_classes))
        self.pulls = 0
        self.device = resolve_device(device)
        self.to(self.device).eval().requires_grad_(False)

    # -- loading ------------------------------------------------------------
    @staticmethod
    def introspect(sd) -> dict:
        """The head structure of a torchvision detection state dict (a
        layout other than torchvision's v2 fails the strict load)."""
        if any(k.startswith("roi_heads.box_head.fc6") for k in sd):
            raise RuntimeError(
                "this checkpoint uses the v1 TwoMLPHead layout; only the "
                "fasterrcnn_resnet50_fpn_v2 layout (conv-FC box head, the "
                "reference's checkpoint) is supported")
        rpn_idx = [int(k.split(".")[3]) for k in sd
                   if k.startswith("rpn.head.conv.")
                   and k.split(".")[3].isdigit()]
        if not rpn_idx:
            raise RuntimeError(
                "unrecognized RPN head layout (expected the v2 "
                "rpn.head.conv.<i>.<j> Sequential keys)")
        box_keys = [k for k in sd if k.startswith("roi_heads.box_head.")]
        fc = [k for k in box_keys if k.endswith("weight") and sd[k].ndim == 2]
        return dict(
            num_classes=int(
                sd["roi_heads.box_predictor.cls_score.weight"].shape[0]),
            rpn_depth=1 + max(rpn_idx),
            rpn_norm=any(k.startswith("rpn.head.conv.0.1.") for k in sd),
            box_convs=len({k.split(".")[2] for k in box_keys
                           if sd[k].ndim == 4}),
            box_fc=int(sd[fc[0]].shape[0]))

    @classmethod
    def load_pth(cls, pth_path: str, device="cuda", **kw):
        """The detector from a torchvision checkpoint (a plain state dict:
        torch.load with weights_only), loaded strict."""
        sd = load_torch_state_dict(pth_path)
        det = cls(**{**cls.introspect(sd), **kw}, device=device)
        det.load_state_dict(sd, strict=True)
        return det

    # -- inference ----------------------------------------------------------
    @contextlib.contextmanager
    def _stage(self, timers, name):
        """Time a stage into `timers` (utils/profiling.HostTimers), the
        device's work included: synchronized at both ends, only when
        timed."""
        if timers is None:
            yield
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with timers.track(name):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def _pull(self, t: torch.Tensor) -> np.ndarray:
        self.pulls += 1
        return t.cpu().numpy()

    def _preprocess(self, frame):
        """(H, W, 3) uint8 frame -> normalised (1, 3, H', W') on the
        device, resized so the short side is min_size (the long side at
        most max_size) and zero-padded to a multiple of 32."""
        c = self.cfg
        img = (frame.to(self.device) if isinstance(frame, torch.Tensor)
               else torch.from_numpy(np.ascontiguousarray(frame)).to(
                   self.device))
        h, w = img.shape[:2]
        scale = min(c["min_size"] / min(h, w), c["max_size"] / max(h, w))
        nh, nw = int(round(h * scale)), int(round(w * scale))
        if (nh, nw) != (h, w):
            img = resize_linear_u8(img, nh, nw)
        mean = torch.tensor(_IMAGENET_MEAN, device=self.device)
        std = torch.tensor(_IMAGENET_STD, device=self.device)
        x = (img.float() / 255.0 - mean) / std
        x = F.pad(x.permute(2, 0, 1), (0, -nw % 32, 0, -nh % 32))
        return x[None].contiguous(), (nh, nw)

    def _proposals(self, obj_all, dl_all, shapes, img_hw):
        """RPN post-processing on the host (torchvision filter_proposals)."""
        c = self.cfg
        A = len(ASPECT_RATIOS)
        all_boxes, all_scores, all_lvl = [], [], []
        start = 0
        for lvl, (fh, fw) in enumerate(shapes):
            n = fh * fw * A
            obj = obj_all[start:start + n]
            dl = dl_all[start * 4:(start + n) * 4].reshape(n, 4)
            start += n
            anchors = level_anchors(fh, fw, STRIDES[lvl], ANCHOR_SIZES[lvl])
            k = min(c["rpn_pre_nms"], n)
            top = np.argpartition(-obj, k - 1)[:k]
            boxes = clip_boxes(decode_boxes(dl[top], anchors[top]), *img_hw)
            keep = ((boxes[:, 2] - boxes[:, 0] >= 1e-3)
                    & (boxes[:, 3] - boxes[:, 1] >= 1e-3))
            all_boxes.append(boxes[keep])
            all_scores.append(obj[top][keep])
            all_lvl.append(np.full(int(keep.sum()), lvl, np.int64))
        boxes = np.concatenate(all_boxes, 0)
        keep = batched_nms(boxes, np.concatenate(all_scores, 0),
                           np.concatenate(all_lvl, 0), c["rpn_nms_thresh"])
        return boxes[keep[:c["rpn_post_nms"]]]

    @torch.no_grad()
    def forward_backbone(self, x):
        """FPN levels and the RPN's (logits, deltas) per level."""
        f = self.backbone.body(x)
        fpn = self.backbone.fpn({k: f[k] for k in ("2", "3", "4", "5")})
        levels = [fpn[k] for k in LEVELS]
        return levels, [self.rpn.head(lv) for lv in levels]

    @torch.no_grad()
    def detect(self, frame_rgb_uint8, timers=None):
        """The eval/detector.py contract on an RGB uint8 (H, W, 3) frame
        (numpy or tensor): {"boxes" (K, 4) frame-pixel xyxy, "labels" (K,)
        1-based COCO ids, "scores" (K,)}. `timers` (HostTimers), when
        given, takes each stage's time: rcnn_backbone (preprocess, body,
        FPN, RPN head and the pull), rcnn_proposals (host),
        rcnn_roi_align, rcnn_box_head (with its pull), rcnn_postprocess
        (host)."""
        c = self.cfg
        h0, w0 = frame_rgb_uint8.shape[:2]
        with self._stage(timers, "rcnn_backbone"):
            x, (nh, nw) = self._preprocess(frame_rgb_uint8)
            levels, rpn = self.forward_backbone(x)
            # NCHW -> the (H, W, A) anchor order; one pull for all levels
            flat = self._pull(torch.cat(
                [o.permute(0, 2, 3, 1).reshape(-1) for o, _ in rpn]
                + [d.permute(0, 2, 3, 1).reshape(-1) for _, d in rpn]))
        shapes = [tuple(lv.shape[-2:]) for lv in levels]
        n_obj = sum(h * w for h, w in shapes) * len(ASPECT_RATIOS)
        with self._stage(timers, "rcnn_proposals"):
            rois = self._proposals(flat[:n_obj], flat[n_obj:], shapes,
                                   (nh, nw))
        if rois.shape[0] == 0:
            return _empty()

        with self._stage(timers, "rcnn_roi_align"):
            lvl = map_levels(rois)
            order, chunks = [], []
            for li in range(4):
                sel = np.where(lvl == li)[0]
                if sel.size:
                    chunks.append(roi_align(levels[li][0], rois[sel],
                                            1.0 / STRIDES[li]))
                    order.append(sel)
            order = np.concatenate(order, 0)
            crops = torch.cat(chunks, 0).contiguous()
        with self._stage(timers, "rcnn_box_head"):
            scores, deltas = self.roi_heads.box_predictor(
                self.roi_heads.box_head(crops))
            both = self._pull(torch.cat([scores, deltas], 1))
        n, nc = rois.shape[0], c["num_classes"]
        # row j of the level-sorted outputs belongs to roi order[j]
        scores = np.empty((n, nc), np.float32)
        deltas = np.empty((n, nc, 4), np.float32)
        scores[order] = both[:, :nc]
        deltas[order] = both[:, nc:].reshape(n, nc, 4)

        with self._stage(timers, "rcnn_postprocess"):
            return self._postprocess(rois, scores, deltas, (nh, nw),
                                     (h0, w0))

    def _postprocess(self, rois, scores, deltas, hw, hw0):
        c = self.cfg
        (nh, nw), (h0, w0) = hw, hw0
        out_boxes, out_scores, out_labels = [], [], []
        for cls in range(1, c["num_classes"]):  # skip background 0
            s = scores[:, cls]
            sel = s > c["score_thresh"]
            if not sel.any():
                continue
            b = clip_boxes(decode_boxes(deltas[sel, cls], rois[sel],
                                        weights=(10.0, 10.0, 5.0, 5.0)),
                           nh, nw)
            ok = (b[:, 2] - b[:, 0] >= 1e-2) & (b[:, 3] - b[:, 1] >= 1e-2)
            out_boxes.append(b[ok])
            out_scores.append(s[sel][ok])
            out_labels.append(np.full(int(ok.sum()), cls, np.int64))
        if not out_boxes:
            return _empty()
        boxes = np.concatenate(out_boxes, 0)
        fscores = np.concatenate(out_scores, 0)
        labels = np.concatenate(out_labels, 0)
        keep = batched_nms(boxes, fscores, labels, c["nms_thresh"])
        keep = keep[:c["detections"]]
        # back to the frame with per-axis ratios (torchvision resize_boxes)
        out = boxes[keep].copy()
        out[:, [0, 2]] *= w0 / nw
        out[:, [1, 3]] *= h0 / nh
        return {"boxes": out, "labels": labels[keep],
                "scores": fscores[keep]}


def build_eval_adapter(pth_path: str, min_size=1088, max_size=1920,
                       device="cuda"):
    """eval/detector.py contract: decoded [0, 1] (1, H, W, C), numpy or a
    tensor, -> dict (the min/max size the reference passes to
    torchvision)."""
    det = FasterRCNNNativeDetector.load_pth(pth_path, device=device,
                                            min_size=min_size,
                                            max_size=max_size)

    def adapter(decoded):
        if isinstance(decoded, torch.Tensor):
            frame = torch.round(decoded[0] * 255).clamp(0, 255).to(
                torch.uint8)
        else:
            frame = np.rint(np.asarray(decoded)[0] * 255).clip(
                0, 255).astype(np.uint8)
        return det.detect(frame)

    adapter.detector = det
    return adapter
