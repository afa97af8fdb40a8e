"""What the three detector and OCR trainers share: one optimizer step
from a loss, the split of a run's time between host synthesis and the
steps, and the rule that a trainer never writes into pretrained/.

The trainers (vcm_ts_tpu_torch/train_plate_ocr.py, train_plate_detector.py,
train_face_detector.py) draw every batch on the host in numpy, one Python
loop per scene, then run one step on the device. `RunClock` adds up the
host seconds spent drawing, the wall seconds of the steps (each ends in a
pull of its loss, so the device has finished it) and, on the card, the
span between CUDA events around each step: from its first kernel to its
last, with the gaps where the device waits for the host's launches (the
device's busy time needs the profiler: chip_smoke.py phase 15).
"""

from __future__ import annotations

import os
import time

import torch
import torch.nn as nn

from ..utils.weights import PRETRAINED


def trainable(model: nn.Module):
    """(names, parameters) of the model's tensors that require a
    gradient, in the model's order."""
    pairs = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    return [n for n, _ in pairs], [p for _, p in pairs]


def optimizer_step(model: nn.Module, opt, loss: torch.Tensor) -> None:
    """d loss / d every trainable tensor, then one optimizer update (a
    tensor the loss does not reach, as ONet's landmark head, gets a zero
    gradient: decay alone, as optax gives it)."""
    names, params = trainable(model)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    opt.step(dict(zip(names, grads)))


def refuse_pretrained(path: str) -> str:
    """`path`, unless it lies in the repository's pretrained/ (the shipped
    weights the tests and the pipeline read): a trainer writes elsewhere."""
    here = os.path.realpath(path)
    if os.path.commonpath([here, os.path.realpath(PRETRAINED)]) == \
            os.path.realpath(PRETRAINED):
        raise ValueError(f"{path}: the trainers do not write into "
                         "pretrained/; pass another --out")
    return path


class RunClock:
    """Host synthesis seconds, step wall seconds and (on the card) the
    steps' device span over a run."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.synth_s = self.step_s = self.span_s = 0.0
        self.steps = 0
        self._t = 0.0

    def synth_start(self):
        self._t = time.perf_counter()

    def synth_end(self):
        self.synth_s += time.perf_counter() - self._t

    def step(self, fn, *args):
        """fn(*args) -> loss tensor; returns the loss as a float."""
        t0 = time.perf_counter()
        if self.cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        loss = fn(*args)
        if self.cuda:
            ev[1].record()
        value = float(loss)
        if self.cuda:
            self.span_s += ev[0].elapsed_time(ev[1]) / 1e3
        self.step_s += time.perf_counter() - t0
        self.steps += 1
        return value

    def record(self) -> dict:
        n = max(self.steps, 1)
        return {"steps": self.steps,
                "synth_ms_per_batch": 1e3 * self.synth_s / n,
                "step_wall_ms": 1e3 * self.step_s / n,
                "step_span_ms": (1e3 * self.span_s / n if self.cuda
                                 else None)}
