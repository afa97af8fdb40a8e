"""Single-process training CLI.

    python -m vcm_ts_tpu_torch.trainer --config-file CFG.yaml \
        [--device cuda|cpu] [--seed 0] [KEY VALUE ...]

The port's counterpart of the root trainer.py: merge the YAML config (the
port's YAML subset, utils/config.py) and the KEY VALUE overrides into the
training defaults, freeze, write OUTPUT_DIR/cfg.yaml, build the DMC, the
loaders and the checkpointer, resume from the newest checkpoint in
OUTPUT_DIR (or MODEL.PRETRAINED_WEIGHTS), bootstrap the I-frames from
MODEL.I_FRAME_PRETRAINED_WEIGHTS (a reference .pth or a port checkpoint of
an IntraNoAR), build the object-detection loader and detector when
DATASET.TEST_OD_ROOT_DIRS is set, and run the stage curriculum
(train/train_loop.do_train).

Without PRETRAINED_WEIGHTS or a checkpoint the DMC starts from the port's
seeded init (utils/weights.init_params with --seed). When a stage has its
perceptual-loss field true, the SOLVER.PL_MODEL network (resnet, fpn or
yolo; train/losses.get_perceptual_loss) is built once, frozen and outside
the optimizer and the checkpoints, and handed to the loop.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .data import make_data_loader, make_object_detection_data_loader
from .eval.detector import build_eval_detector
from .models.dmc import DMC
from .models.intra import IntraNoAR
from .train.checkpoint import CheckPointer
from .train.losses import get_perceptual_loss
from .train.train_loop import do_train
from .utils.common import enable_debug_nans, interpolate_log
from .utils.config import default_training_cfg
from .utils.device import resolve_device
from .utils.logger import setup_logger
from .utils.weights import get_i_frame_q_scales_from_ckpt, init_params


def _i_frame_fn(cfg, device, logger):
    """The I-frame bootstrap: a clipped IntraNoAR forward at the q scales of
    the rate anchors (the checkpoint's, log-interpolated when it has another
    count), on (N, H, W, 3) host batches."""
    path = cfg.MODEL.I_FRAME_PRETRAINED_WEIGHTS
    i_model = IntraNoAR(device=device)
    CheckPointer(logger=logger).load(i_model, path=path, use_latest=False)
    i_model.eval()
    if path.endswith(".pth"):
        q_scales = get_i_frame_q_scales_from_ckpt(path)
    else:
        q_scales = i_model.q_scale.detach().float().cpu().numpy().reshape(-1)
    n = len(cfg.SOLVER.LAMBDAS)
    if len(q_scales) != n:
        q_scales = interpolate_log(q_scales[-1], q_scales[0], n)
    q = torch.as_tensor(np.asarray(q_scales, np.float32).reshape(-1, 1, 1, 1),
                        device=device)

    @torch.no_grad()
    def i_frame_fn(batch):
        x = torch.as_tensor(np.asarray(batch, np.float32), device=device)
        return torch.clamp(i_model(x, q)["x_hat"], 0, 1)

    return i_frame_fn


def train_model(cfg, args):
    device = resolve_device(args.device)
    logger = setup_logger("CORE", 0, cfg.OUTPUT_DIR)
    if cfg.SOLVER.DEBUG_NANS:
        enable_debug_nans()
        logger.info("autograd anomaly mode ON (debug only: slow)")

    cmv, cn, cm = cfg.MODEL.CHANNELS
    model = init_params(DMC(anchor_num=len(cfg.SOLVER.LAMBDAS),
                            channel_mv=cmv, channel_N=cn, channel_M=cm,
                            device=device), seed=args.seed)

    checkpointer = CheckPointer(cfg.OUTPUT_DIR, logger)
    start_epoch = 0
    resume_opt_state = None
    if cfg.MODEL.PRETRAINED_WEIGHTS or checkpointer.has_checkpoint():
        extra = checkpointer.load(
            model, path=cfg.MODEL.PRETRAINED_WEIGHTS or None)
        start_epoch = int(extra.get("epoch", 0))
        # the optimizer exists only once do_train enters the resumed stage;
        # it restores this state there on a mid-stage resume
        resume_opt_state = checkpointer.load_opt_state(
            path=cfg.MODEL.PRETRAINED_WEIGHTS or None)

    i_frame_fn = (_i_frame_fn(cfg, device, logger)
                  if cfg.MODEL.I_FRAME_PRETRAINED_WEIGHTS else None)

    pl_fn = None
    if any(stage[7] == "true" for stage in cfg.SOLVER.STAGES):
        pl_fn = get_perceptual_loss(cfg, device, seed=args.seed)

    train_loader = make_data_loader(cfg, args.seed, is_train=True)
    test_loader = (make_data_loader(cfg, args.seed, is_train=False)
                   if cfg.DATASET.TEST_ROOT_DIRS else None)

    # OD-mAP during training, built only when the curriculum reaches
    # OD_STAGE (eval_dataset gates per stage)
    od_loader = detector_fn = None
    if (cfg.DATASET.TEST_OD_ROOT_DIRS
            and len(cfg.SOLVER.STAGES) + 1 > cfg.DATASET.OD_STAGE):
        od_loader = make_object_detection_data_loader(cfg)
        detector_fn = build_eval_detector(cfg, device=device)

    return do_train(cfg, model, train_loader, checkpointer,
                    start_epoch=start_epoch, seed=args.seed,
                    test_loader=test_loader, i_frame_fn=i_frame_fn,
                    pl_fn=pl_fn, od_loader=od_loader, detector_fn=detector_fn,
                    resume_opt_state=resume_opt_state)


def main(argv=None):
    parser = argparse.ArgumentParser(description="DCVC-HEM training")
    parser.add_argument("--config-file", type=str, default="",
                        help="path to yaml config")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="overrides: KEY VALUE pairs")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    cfg = default_training_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()

    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    with open(os.path.join(cfg.OUTPUT_DIR, "cfg.yaml"), "w") as f:
        f.write(cfg.dump())

    return train_model(cfg, args)


if __name__ == "__main__":
    main()
