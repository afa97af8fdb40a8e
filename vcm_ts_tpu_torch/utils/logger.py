"""Named loggers, rank-gated (the port's copy of
vcm_ts_tpu/utils/logger.py)."""

from __future__ import annotations

import logging
import os
import sys


def setup_logger(name: str, rank: int = 0, save_dir: str = ""):
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if rank > 0 or logger.handlers:
        return logger
    stream_handler = logging.StreamHandler(stream=sys.stdout)
    formatter = logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s: %(message)s")
    stream_handler.setFormatter(formatter)
    logger.addHandler(stream_handler)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, "logs.txt"))
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger
