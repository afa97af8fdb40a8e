"""Ops whose result for one batch row does not depend on the rest of the
batch.

A batch of N streams (`compress_batch`, `decompress_batch`) must code each
row to the same bits as that row coded alone: otherwise a stream written in
a batch desyncs when it is decoded alone. Libraries pick an algorithm, and
so a summation order, by the size of the whole call. Measured at N = 2
against N = 1 on the rows of one batch: on the CPU, oneDNN's convs (a
4x4x192 3x3 conv, 7e-6 apart) and the dense layers' matrix product; on an
H100, cuDNN's deterministic convs (f32 and bf16, at 68x120 and 136x240
among others; in bf16 the I-frame's streams differed), cuBLAS's dense
layers, and the f32 channel means of the SE layers (1e-9 apart). So these
three go one row at a time. Elementwise ops, resampling, pooling, concatenation and the
hand-written kernels compute each output from its own row in a fixed
order and take the whole batch (checked on the H100 module by module).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def per_row(fn, x, *args):
    """fn(x, *args), row by row along N when N > 1."""
    if x.shape[0] == 1:
        return fn(x, *args)
    return torch.cat([fn(x[i:i + 1], *args) for i in range(x.shape[0])])


def conv2d(x, w, b=None, stride=1, padding=0):
    return per_row(F.conv2d, x, w, b, stride, padding)


def linear(x, w, b=None):
    return per_row(F.linear, x, w, b)


def _mean_hw(x):
    return x.mean(dim=(2, 3), dtype=torch.float32)


def mean_hw(x):
    """The f32 mean over H and W of an NCHW tensor, (N, C)."""
    return per_row(_mean_hw, x)
