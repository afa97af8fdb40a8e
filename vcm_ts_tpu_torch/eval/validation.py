"""Validation: no-grad eval over the test loader, and the detection-mAP
branch (the port's counterpart of vcm_ts_tpu/eval/validation.py).

`eval_dataset` re-uses the training loss (train/train_step.frame_loss with
training=False: rounded latents, no noise, no optimizer) and averages
loss / rate / dist / p_dist / bpp / psnr per rate anchor. The detection
branch codes every OD_GOP_SIZE-th frame with the I-frame net (or keeps it),
chains the others through the plain forward at every rate anchor at once
(the anchors ride the batch axis), and scores `detector_fn`'s detections on
the decoded frames with eval/detection_metrics.

Both run under torch.no_grad() with the model in eval mode, and give the
model back in the mode it came in.
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch

from ..models.dmc import make_dpb
from ..ops import rowwise
from ..train.train_step import frame_loss, to_f32

_FIELDS = ("loss", "rate", "dist", "p_dist", "bpp", "psnr")


@contextlib.contextmanager
def _eval_mode(model):
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(was_training)


def _device(model):
    return next(model.parameters()).device


def eval_dataset(model, stage, data_loader, cfg, lambdas, i_frame_fn=None,
                 pl_fn=None, od_loader=None, detector_fn=None):
    """Returns a dict of per-lambda metric arrays (and "mean_ap" once the
    curriculum reaches cfg.DATASET.OD_STAGE with a detector)."""
    logger = logging.getLogger("CORE")
    dev = _device(model)
    lambdas_t = torch.as_tensor(np.asarray(lambdas, np.float32), device=dev)
    pl = pl_fn if stage.perceptual_loss else None

    sums = {k: [] for k in _FIELDS}
    # data_loader may be None for detection-only eval (TEST_OD_ROOT_DIRS
    # configured without TEST_ROOT_DIRS)
    with _eval_mode(model), rowwise.whole_batch():
        for inputs, targets in (data_loader or ()):
            t = inputs.shape[1]
            p_frames = min(stage.p_frames, t - 1)
            for t_i in range(t - p_frames):
                ref = (i_frame_fn(inputs[:, t_i]) if i_frame_fn is not None
                       else inputs[:, t_i])
                dpb = make_dpb(to_f32(ref, dev), model.channel_N,
                               model.channel_M)
                for p_idx in range(p_frames):
                    _, (aux, dpb) = frame_loss(
                        model, to_f32(inputs[:, t_i + 1 + p_idx], dev),
                        to_f32(targets[:, t_i + 1 + p_idx], dev), dpb,
                        lambdas=lambdas_t, dist_lambda=cfg.SOLVER.DIST_LAMBDA,
                        pl_lambda=cfg.SOLVER.PL_LAMBDA,
                        loss_rate_keys=stage.loss_rate_keys,
                        loss_dist_key=stage.loss_dist_key, pl_fn=pl,
                        noise=None, is_first_p=p_idx == 0, training=False)
                    for k in _FIELDS:
                        sums[k].append(getattr(aux, k))

    result = {} if not sums["loss"] else {
        k: torch.stack(v).mean(0).cpu().numpy() for k, v in sums.items()}

    # stage.stage is the 0-based curriculum index; OD_STAGE is 1-based
    if (od_loader is not None and detector_fn is not None
            and stage.stage + 1 >= cfg.DATASET.OD_STAGE):
        n = len(lambdas)
        od_i_fn = (None if i_frame_fn is None else
                   lambda x: i_frame_fn(np.tile(np.asarray(x), (n, 1, 1, 1))))
        result["mean_ap"] = eval_object_detection(
            model, cfg, lambdas, od_loader, detector_fn, od_i_fn)
    elif od_loader is not None and detector_fn is None:
        logger.warning("OD loader given but no detector adapter available; "
                       "skipping mAP eval")
    return result


def eval_object_detection(model, cfg, lambdas, od_loader, detector_fn,
                          i_frame_fn):
    """Detection mAP per rate anchor: every OD_GOP_SIZE-th frame re-keyed
    through i_frame_fn ((1, H, W, C) -> all n rate rows), the others
    chained per anchor through the plain forward in one batched pass, the
    detector run on each decoded row. Returns an (n,) array of mAP."""
    from .detection_metrics import MeanAveragePrecision

    dev = _device(model)
    n = len(lambdas)
    maps = [MeanAveragePrecision() for _ in range(n)]
    dpb = None  # row r is rate anchor r's chained DPB
    first_p = False  # True exactly for the first chained frame after a rekey

    with _eval_mode(model), rowwise.whole_batch():
        mv_qs = model.mv_y_q_scale[:n]
        y_qs = model.y_q_scale[:n]
        for idx, (image, annotations) in enumerate(od_loader):
            x = to_f32(np.asarray(image[0]), dev)  # (1, H, W, C)
            if idx % cfg.DATASET.OD_GOP_SIZE == 0:
                ref = (to_f32(i_frame_fn(x.cpu().numpy()), dev)
                       if i_frame_fn is not None else x.repeat(n, 1, 1, 1))
                dpb = make_dpb(ref, model.channel_N, model.channel_M)
                rekey = True
            else:
                dpb = model(x.repeat(n, 1, 1, 1), dpb, mv_qs, y_qs, first_p,
                            training=False)["dpb"]
                rekey = False
            decoded = torch.clamp(dpb["ref_frame"], 0, 1).cpu().numpy()
            for r in range(n):
                maps[r].update(detector_fn(decoded[r:r + 1]), annotations[0])
            first_p = rekey

    return np.asarray([m.compute()["map"] for m in maps])
