"""COCO-style mean average precision in numpy (the port's copy of
vcm_ts_tpu/eval/detection_metrics.py): IoU thresholds 0.50:0.05:0.95,
101-point interpolated AP per class, map_50 and the per-class breakdown.
"""

from __future__ import annotations

import numpy as np

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix between (N,4) and (M,4) xyxy boxes."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


class MeanAveragePrecision:
    def __init__(self, iou_thresholds=IOU_THRESHOLDS):
        self.iou_thresholds = np.asarray(iou_thresholds)
        self._images = []  # list of (preds, target) dicts

    def update(self, preds: dict, target: dict):
        """preds: {boxes (N,4), scores (N,), labels (N,)};
        target: {boxes (M,4), labels (M,)} — same schema as torchmetrics."""
        self._images.append((
            {k: np.asarray(v) for k, v in preds.items()},
            {k: np.asarray(v) for k, v in target.items()}))

    def compute(self) -> dict:
        classes = sorted({int(c) for _, t in self._images
                          for c in np.asarray(t["labels"]).reshape(-1)})
        n_thr = len(self.iou_thresholds)
        ap = np.full((n_thr, len(classes)), np.nan)

        for ci, cls in enumerate(classes):
            scores, matches, n_gt = [], [], 0
            # matches: (n_det, n_thr) bool
            for preds, target in self._images:
                gt_mask = target["labels"].reshape(-1) == cls
                gt_boxes = target["boxes"].reshape(-1, 4)[gt_mask]
                n_gt += gt_boxes.shape[0]
                det_mask = preds["labels"].reshape(-1) == cls
                det_boxes = preds["boxes"].reshape(-1, 4)[det_mask]
                det_scores = preds["scores"].reshape(-1)[det_mask]
                order = np.argsort(-det_scores)
                det_boxes, det_scores = det_boxes[order], det_scores[order]
                iou = box_iou(det_boxes, gt_boxes)
                m = np.zeros((det_boxes.shape[0], n_thr), bool)
                for ti, thr in enumerate(self.iou_thresholds):
                    taken = np.zeros(gt_boxes.shape[0], bool)
                    for di in range(det_boxes.shape[0]):
                        if gt_boxes.shape[0] == 0:
                            break
                        cand = np.where(~taken & (iou[di] >= thr))[0]
                        if cand.size:
                            best = cand[np.argmax(iou[di][cand])]
                            taken[best] = True
                            m[di, ti] = True
                scores.append(det_scores)
                matches.append(m)

            if n_gt == 0:
                continue
            if scores:
                scores = np.concatenate(scores)
                matches = np.concatenate(matches, axis=0)
                order = np.argsort(-scores)
                matches = matches[order]
            else:
                matches = np.zeros((0, n_thr), bool)

            for ti in range(n_thr):
                tp = np.cumsum(matches[:, ti])
                fp = np.cumsum(~matches[:, ti])
                recall = tp / n_gt
                precision = tp / np.maximum(tp + fp, 1e-9)
                # monotone precision envelope + 101-point interpolation
                for i in range(precision.size - 2, -1, -1):
                    precision[i] = max(precision[i], precision[i + 1])
                interp = np.zeros_like(RECALL_POINTS)
                if recall.size:
                    idx = np.searchsorted(recall, RECALL_POINTS, side="left")
                    valid = idx < recall.size
                    interp[valid] = precision[idx[valid]]
                ap[ti, ci] = interp.mean()

        with np.errstate(invalid="ignore"):
            result = {
                "map": float(np.nanmean(ap)) if ap.size else 0.0,
                "map_50": float(np.nanmean(ap[0])) if ap.size else 0.0,
                "map_per_class": (np.nanmean(ap, axis=0) if ap.size
                                  else np.zeros(0)),
                "classes": np.asarray(classes),
            }
        return result
