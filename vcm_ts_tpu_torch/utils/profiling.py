"""Tracing helpers (the port's copy of vcm_ts_tpu/utils/profiling.py): a
torch.profiler trace of the device work, written as a Chrome trace, and
named host-side timers for the rANS stages."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler over the block (host ops, and the card's kernels when
    CUDA is available); writes <log_dir>/trace.json (chrome://tracing,
    Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class HostTimers:
    """Named accumulating host timers (encode/decode/rANS stages)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def track(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self, logger: logging.Logger | None = None) -> dict:
        out = {name: {"total_s": self.totals[name],
                      "count": self.counts[name],
                      "mean_ms": self.totals[name] / max(self.counts[name], 1)
                      * 1000}
               for name in self.totals}
        if logger is not None:
            for name, stats in sorted(out.items()):
                logger.info("%s: %.2f ms avg over %d calls",
                            name, stats["mean_ms"], stats["count"])
        return out
