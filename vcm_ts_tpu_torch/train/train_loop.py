"""The training loop: stage curriculum over epochs, per-iteration steps,
eval and checkpoints after each epoch (the port's counterpart of
vcm_ts_tpu/train/train_loop.py).

Each stage change builds a fresh StageOptimizer for the stage's trainable
mask and a new step (single or cascade; SOLVER.MIXED_PRECISION,
CASCADE_REMAT and GRAD_ACCUM_STEPS as in the JAX loop). A resume that
starts inside a stage (not at its first epoch) restores the checkpoint's
optimizer moments; at a stage boundary the optimizer starts fresh.

Noise comes from one torch.Generator on the model's device, seeded at
each epoch from (seed, epoch), so a run resumed at an epoch draws that
epoch's noise as the uninterrupted run did. (The loader's random crops
keep the JAX package's draws: one numpy generator per loader, which a
resumed run builds afresh.) One process, one device: the JAX loop's `mesh`
and `fsdp` (data, tensor and fully sharded parallel training) wait for the
port's parallel/ package (ROADMAP.md Queue 1 item 6) and raise.

`do_train` returns a record of the run: per epoch its stage, frames
trained, the seconds spent in the steps, waiting on the loader, in eval and
in the checkpoint, and per iteration the mean loss, bpp and psnr per rate
anchor.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from ..eval.validation import eval_dataset
from . import train_step as ts
from .optimizer import make_stage_optimizer
from .stages import calc_max_epoch, get_stage_params
from .tensorboard import BestWorstSampleTracker, MetricWriter

PARALLEL_WAITS = ("data-, tensor- and fully-sharded-parallel training wait "
                  "for the port's parallel/ package, ROADMAP.md Queue 1 "
                  "item 6")


def _mean_aux(aux_list) -> dict:
    """Per-anchor means over an iteration's FrameAux list, on the host."""
    return {k: torch.stack([getattr(a, k) for a in aux_list]).mean(0)
            .float().cpu().numpy()
            for k in ("loss", "rate", "dist", "p_dist", "bpp", "psnr")}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def do_train(cfg, model, data_loader, checkpointer, start_epoch: int = 0,
             seed: int = 0, test_loader=None, i_frame_fn=None, pl_fn=None,
             writer: Optional[MetricWriter] = None, mesh=None,
             od_loader=None, detector_fn=None,
             resume_opt_state: Optional[dict] = None, fsdp: bool = False):
    """Runs the stage curriculum from start_epoch, training `model` in
    place; returns the run's record (see the module docstring)."""
    if mesh is not None or fsdp:
        raise NotImplementedError(PARALLEL_WAITS)
    logger = logging.getLogger("CORE")
    max_epoch = calc_max_epoch(cfg.SOLVER.STAGES)
    lambdas = [float(v) for v in cfg.SOLVER.LAMBDAS]
    device = next(model.parameters()).device

    own_writer = writer is None
    if own_writer:
        writer = MetricWriter(cfg.OUTPUT_DIR)
    tracker = None
    if (cfg.TENSORBOARD.BEST_SAMPLES_NUM > 0
            or cfg.TENSORBOARD.WORST_SAMPLES_NUM > 0):
        tracker = BestWorstSampleTracker(
            lambdas, cfg.TENSORBOARD.BEST_SAMPLES_NUM,
            cfg.TENSORBOARD.WORST_SAMPLES_NUM)

    cur_stage_idx = -1
    opt = step_fn = None
    accum = int(getattr(cfg.SOLVER, "GRAD_ACCUM_STEPS", 1))
    generator = torch.Generator(device=device)
    global_step = start_epoch * max(1, len(data_loader))
    record = {"epochs": [], "iterations": []}

    model.train()
    for epoch in range(start_epoch, max_epoch):
        stage = get_stage_params(cfg, epoch)
        if stage.stage != cur_stage_idx:
            cur_stage_idx = stage.stage
            logger.info("Entering stage %d: %s", stage.stage, stage)
            if stage.perceptual_loss and pl_fn is None:
                raise ValueError(
                    f"stage {stage.stage} has perceptual_loss true but no "
                    "pl_fn was given (build one with "
                    "train/losses.get_perceptual_loss)")
            opt = make_stage_optimizer(
                model, stage.trainable_mode, stage.lr,
                grad_clip_norm=float(
                    getattr(cfg.SOLVER, "GRAD_CLIP_NORM", 0.0)))
            # Mid-stage resume: restore the saved moments, else the resumed
            # trajectory differs from an uninterrupted run. Only when
            # start_epoch is not this stage's first epoch: at a stage
            # boundary the optimizer starts fresh by design.
            if (resume_opt_state is not None and epoch == start_epoch
                    and start_epoch > 0
                    and get_stage_params(cfg, start_epoch - 1).stage
                    == stage.stage):
                try:
                    opt.load_state_dict(resume_opt_state)
                    logger.info("Restored optimizer state mid-stage "
                                "(epoch %d)", start_epoch)
                except (ValueError, KeyError) as e:
                    logger.warning("Could not restore optimizer state "
                                   "(%s); continuing with fresh moments", e)
            pl = pl_fn if stage.perceptual_loss else None
            compute_dtype = (torch.bfloat16 if getattr(
                cfg.SOLVER, "MIXED_PRECISION", False) else None)
            common = dict(lambdas=lambdas, dist_lambda=cfg.SOLVER.DIST_LAMBDA,
                          pl_lambda=cfg.SOLVER.PL_LAMBDA, pl_fn=pl,
                          compute_dtype=compute_dtype)
            if stage.forward_method == "single":
                step_fn = ts.make_single_frame_step(model, opt, stage,
                                                    **common)
            else:
                step_fn = ts.make_cascade_step(
                    model, opt, stage,
                    remat=getattr(cfg.SOLVER, "CASCADE_REMAT", True),
                    accum_steps=accum, **common)

        data_loader.set_epoch(epoch)
        generator.manual_seed(int(np.random.SeedSequence(
            [seed, epoch]).generate_state(1)[0]))
        ep = {"epoch": epoch, "stage": stage.stage, "frames": 0,
              "train_s": 0.0, "loader_wait_s": 0.0, "eval_s": 0.0,
              "checkpoint_s": 0.0}
        t_epoch = t_wait = time.perf_counter()
        for it, (inputs, targets) in enumerate(data_loader):
            ep["loader_wait_s"] += time.perf_counter() - t_wait
            sample_cb = tracker.update if tracker is not None else None
            if stage.forward_method == "single":
                aux_list = ts.run_single_sequence(
                    model, step_fn, inputs, targets, stage, generator,
                    i_frame_fn=i_frame_fn, sample_cb=sample_cb)
            else:
                aux_list = ts.run_cascade_sequence(
                    model, step_fn, inputs, targets, stage, generator,
                    accum_steps=accum, i_frame_fn=i_frame_fn,
                    sample_cb=sample_cb)
            ep["frames"] += inputs.shape[0] * stage.p_frames * (
                inputs.shape[1] - stage.p_frames)
            global_step += 1
            m = _mean_aux(aux_list)  # reads the step's results: a sync
            record["iterations"].append({
                "epoch": epoch, "it": it, "stage": stage.stage,
                **{k: m[k].tolist() for k in ("loss", "bpp", "psnr")}})
            writer.add_metrics("train", m, lambdas, global_step)
            writer.add_scalar("train/stage", stage.stage, global_step)
            writer.add_scalar("train/lr", stage.lr, global_step)
            logger.info(
                "epoch %d it %d stage %d loss %.4f bpp %s psnr %s",
                epoch, it, stage.stage, float(m["loss"].mean()),
                np.round(m["bpp"], 4), np.round(m["psnr"], 2))
            t_wait = time.perf_counter()
        _sync(device)
        ep["train_s"] = time.perf_counter() - t_epoch

        if tracker is not None:
            tracker.write(writer, global_step)

        if test_loader is not None or od_loader is not None:
            t = time.perf_counter()
            eval_metrics = eval_dataset(
                model, stage, test_loader, cfg, lambdas,
                i_frame_fn=i_frame_fn, pl_fn=pl_fn, od_loader=od_loader,
                detector_fn=detector_fn)
            ep["eval_s"] = time.perf_counter() - t
            ep["eval"] = {k: np.asarray(v).tolist()
                          for k, v in eval_metrics.items()}
            writer.add_metrics("eval", eval_metrics, lambdas, global_step)
        if checkpointer is not None:
            t = time.perf_counter()
            checkpointer.save(f"model_epoch_{epoch:03d}", model, opt,
                              epoch=epoch + 1)
            ep["checkpoint_s"] = time.perf_counter() - t
        record["epochs"].append(ep)
        logger.info(
            "epoch %d: %d frames in %.3f s (%.3f frames/s; loader wait "
            "%.3f s), eval %.3f s, checkpoint %.3f s", epoch, ep["frames"],
            ep["train_s"], ep["frames"] / max(ep["train_s"], 1e-9),
            ep["loader_wait_s"], ep["eval_s"], ep["checkpoint_s"])
    if own_writer:
        writer.close()
    return record
