"""Training metric logging: TensorBoard scalars (when the tensorboard
package is there) and always a JSONL file, metrics.jsonl (the port's copy of
vcm_ts_tpu/train/tensorboard.py: the same tags and lines).

Per-lambda scalars for loss / rate / dist / p_dist / bpp / psnr, the stage
and the lr; image strips of the best and worst samples go to TensorBoard
only. Values may be device tensors: they are read to the host here.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch


def _np(v) -> np.ndarray:
    """A host array of a tensor (on any device) or an array-like."""
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v)


class MetricWriter:
    def __init__(self, log_dir: str, enable_tb: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if enable_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def add_scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps(
            {"t": time.time(), "step": step, "tag": tag,
             "value": float(value)}) + "\n")

    def add_metrics(self, prefix: str, metrics: dict, lambdas, step: int):
        """Per-lambda dict logging (tensorboard.py:83-127 semantics)."""
        for key, values in metrics.items():
            values = _np(values).reshape(-1)
            if values.size == len(lambdas):
                for lam, v in zip(lambdas, values):
                    self.add_scalar(f"{prefix}/{key}/lambda_{lam}", v, step)
            else:
                self.add_scalar(f"{prefix}/{key}", float(values.mean()), step)
        self.flush()

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def add_image_grid(self, tag: str, images, step: int):
        """images: list of (H, W, 3) float arrays in [0,1], stacked into a
        horizontal strip."""
        if self._tb is None or not images:
            return
        strip = np.concatenate([_np(im) for im in images], axis=1)
        self._tb.add_image(tag, np.clip(strip, 0, 1).transpose(2, 0, 1), step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class BestWorstSampleTracker:
    """Tracks the N best/worst (by per-sample loss) input-vs-decoded pairs per
    rate anchor within an epoch, emitting image strips to TensorBoard."""

    def __init__(self, lambdas, best_num: int = 16, worst_num: int = 16):
        self.lambdas = list(lambdas)
        self.best_num = best_num
        self.worst_num = worst_num
        self.reset()

    def reset(self):
        self._best = [[] for _ in self.lambdas]   # (loss, input, decoded)
        self._worst = [[] for _ in self.lambdas]

    def update(self, aux, inputs, decoded):
        """inputs/decoded: (N, H, W, 3); aux.loss: (N,)."""
        loss = _np(aux.loss).reshape(-1)
        inputs = _np(inputs)
        decoded = _np(decoded)
        for i in range(min(len(self.lambdas), loss.shape[0])):
            entry = (float(loss[i]), inputs[i], decoded[i])
            best = self._best[i]
            worst = self._worst[i]
            best.append(entry)
            best.sort(key=lambda e: e[0])
            del best[self.best_num:]
            worst.append(entry)
            worst.sort(key=lambda e: -e[0])
            del worst[self.worst_num:]

    def write(self, writer: MetricWriter, step: int):
        for i, lam in enumerate(self.lambdas):
            for kind, entries in (("best", self._best[i]),
                                  ("worst", self._worst[i])):
                for rank, (_, inp, dec) in enumerate(entries):
                    writer.add_image_grid(
                        f"samples/{kind}/lambda_{lam}/{rank}",
                        [inp, np.clip(dec, 0, 1)], step)
        self.reset()
