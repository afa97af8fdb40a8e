"""Stage curriculum: the 8-field stage tuples of the training settings.

The port's copy of vcm_ts_tpu/train/stages.py (same tables and checks):
[p_frames, modules, forward_method, loss_dist, loss_rate, lr, epochs,
perceptual_loss]. Each stage maps to a trainable-mode string, which the
masked optimizer (train/optimizer.py) and DCVC_HEM's activate_modules_*
read.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class StageParams:
    stage: int
    p_frames: int
    trainable_mode: str           # inter_dist | inter_dist_rate | recon_dist
    #                               | recon_dist_rate | all
    forward_method: str           # single | cascade
    loss_dist_key: str            # me_mse | mse
    loss_rate_keys: tuple
    lr: float
    perceptual_loss: bool


_MODE_TABLE = {
    ("me", "none"): "inter_dist",
    ("me", "me"): "inter_dist_rate",
    ("rec", "none"): "recon_dist",
    ("rec", "rec"): "recon_dist_rate",
    ("all", "all"): "all",
}

_RATE_KEYS = {
    "none": (),
    "me": ("bpp_mv_y", "bpp_mv_z"),
    "rec": ("bpp_y", "bpp_z"),
    "all": ("bpp_mv_y", "bpp_mv_z", "bpp_y", "bpp_z"),
}


def _check(stages) -> None:
    for s in stages:
        if len(s) != 8:
            raise ValueError("stage tuples must have 8 fields")


def calc_max_epoch(stages: List[List[str]]) -> int:
    _check(stages)
    return sum(int(s[6]) for s in stages)


def get_stage_params(cfg, epoch: int) -> StageParams:
    stages = cfg.SOLVER.STAGES
    _check(stages)
    stage_idx = None
    epoch_counter = 0
    for i, s in enumerate(stages):
        epoch_counter += int(s[6])
        if epoch < epoch_counter:
            stage_idx = i
            break
    if stage_idx is None:
        raise ValueError(f"epoch {epoch} beyond stage schedule "
                         f"({epoch_counter} total epochs)")
    s = stages[stage_idx]

    p_frames = int(s[0])
    if not 0 < p_frames < cfg.DATASET.SEQUENCE_LENGTH:
        raise ValueError("Invalid 'p_frames' stage parameter")
    key = (s[1], s[4])
    if key not in _MODE_TABLE:
        raise ValueError(f"Invalid pair of modules/loss-rate: {key}")
    if s[2] not in ("single", "cascade"):
        raise ValueError(f"Invalid forward method: {s[2]}")
    dist_keys = {"me": "me_mse", "rec": "mse"}
    if s[3] not in dist_keys:
        raise ValueError(f"Invalid loss dist: {s[3]}")
    if s[4] not in _RATE_KEYS:
        raise ValueError(f"Invalid loss rate: {s[4]}")
    if s[7] not in ("true", "false"):
        raise ValueError("Invalid perceptual loss flag (true or false)")

    return StageParams(
        stage=stage_idx,
        p_frames=p_frames,
        trainable_mode=_MODE_TABLE[key],
        forward_method=s[2],
        loss_dist_key=dist_keys[s[3]],
        loss_rate_keys=_RATE_KEYS[s[4]],
        lr=float(s[5]),
        perceptual_loss=s[7] == "true",
    )
