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
resumed run builds afresh.)

With `mesh` (parallel/mesh.make_global_mesh: the "data" DeviceMesh over the
ranks) training is data parallel: each rank's loader gives its own rows,
rank 0's weights go to every rank at each stage entry, the steps average
the gradients and FrameAux over the ranks, and the lr is scaled by
sqrt(data ranks) (the reference's train_multi.py:158-160). With `fsdp` the
model is sharded over the mesh first (parallel/tensor.shard_params_fsdp)
and each stage's optimizer keeps its moments in the same shards. A data x
model mesh (parallel/mesh.make_global_dp_tp_mesh) whose "model" axis is
larger than 1 splits the model over that axis first
(parallel/tensor.shard_params_tp, the JAX loop's seam at
vcm_ts_tpu/train/train_loop.py:121-136): the ranks of one model group
take the same rows, and the steps average over the "data" axis alone;
fsdp and tensor parallelism exclude each other. Rank 0 alone logs, writes
metrics, runs eval and OD-mAP, and writes checkpoints; under FSDP or
tensor parallelism every rank first joins the gather of the whole weights
and moments (a collective), and rank 0 evaluates a whole copy of the
model. The best/worst sample tracker is off when more than one process
runs.

`do_train` returns a record of the run: per epoch its stage, frames
trained, the seconds spent in the steps, waiting on the loader, in eval and
in the checkpoint, the kernel launches of its steps (ops/cuda_build
.LAUNCHES counted over the epoch's iterations, eval excluded), and per
iteration the mean loss, bpp and psnr per rate
anchor. With more than one process the ranks meet at a barrier before an
epoch's clock starts, and every rank records the slowest rank's step
seconds, so each rank's record gives the same frames/s.
"""

from __future__ import annotations

import copy
import logging
import time
from typing import Optional

import numpy as np
import torch

from ..eval.validation import eval_dataset
from ..ops import cuda_build
from ..parallel import mesh as pm
from ..parallel.tensor import shard_params_fsdp, shard_params_tp
from . import train_step as ts
from .optimizer import make_stage_optimizer
from .stages import calc_max_epoch, get_stage_params
from .tensorboard import BestWorstSampleTracker, MetricWriter


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
    if fsdp and mesh is None:
        raise ValueError("fsdp shards over the data mesh: pass mesh")
    tp = pm.model_size(mesh) > 1
    if fsdp and tp:
        raise ValueError("fsdp and tensor parallelism exclude each other "
                         "(TP already shards the weights, over 'model')")
    logger = logging.getLogger("CORE")
    max_epoch = calc_max_epoch(cfg.SOLVER.STAGES)
    lambdas = [float(v) for v in cfg.SOLVER.LAMBDAS]
    device = next(model.parameters()).device
    # the steps see the data axis alone; the model axis is in the layers
    mesh, full_mesh = pm.data_mesh(mesh), mesh
    world = 1 if mesh is None else mesh.size()
    is_main = pm.is_main_process()
    lr_scale = float(np.sqrt(world))
    compute_dtype = (torch.bfloat16 if getattr(
        cfg.SOLVER, "MIXED_PRECISION", False) else None)
    evaluates = test_loader is not None or od_loader is not None
    eval_model = model
    if fsdp or tp:
        # rank 0 evaluates a whole copy: the sharded model's forward is a
        # collective that the other ranks do not join
        if evaluates:
            eval_model = copy.deepcopy(model)
    if fsdp:
        shard_params_fsdp(pm.replicate(model, mesh), mesh, compute_dtype)
    if tp:
        # global rank 0's whole weights everywhere, then each rank's slices
        n_split = shard_params_tp(pm.replicate(model), full_mesh)
        logger.info("tensor parallelism: mesh %s, %d parameters split over "
                    "'model'", dict(zip(full_mesh.mesh_dim_names,
                                        full_mesh.shape)), n_split)

    own_writer = writer is None and is_main
    if own_writer:
        writer = MetricWriter(cfg.OUTPUT_DIR)
    tracker = None
    if pm.get_world_size() == 1 and (cfg.TENSORBOARD.BEST_SAMPLES_NUM > 0
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
            if mesh is not None and not fsdp:
                pm.replicate(model, mesh)
            opt = make_stage_optimizer(
                model, stage.trainable_mode, stage.lr * lr_scale,
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
            common = dict(lambdas=lambdas, dist_lambda=cfg.SOLVER.DIST_LAMBDA,
                          pl_lambda=cfg.SOLVER.PL_LAMBDA, pl_fn=pl,
                          compute_dtype=compute_dtype, mesh=mesh)
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
        if mesh is not None:
            pm.synchronize()  # one start for every rank's clock
        launches = dict(cuda_build.LAUNCHES)
        t_epoch = t_wait = time.perf_counter()
        for it, (inputs, targets) in enumerate(data_loader):
            ep["loader_wait_s"] += time.perf_counter() - t_wait
            sample_cb = tracker.update if tracker is not None else None
            if stage.forward_method == "single":
                aux_list = ts.run_single_sequence(
                    model, step_fn, inputs, targets, stage, generator,
                    i_frame_fn=i_frame_fn, sample_cb=sample_cb, mesh=mesh)
            else:
                aux_list = ts.run_cascade_sequence(
                    model, step_fn, inputs, targets, stage, generator,
                    accum_steps=accum, i_frame_fn=i_frame_fn,
                    sample_cb=sample_cb, mesh=mesh)
            # frames of the global batch
            ep["frames"] += inputs.shape[0] * world * stage.p_frames * (
                inputs.shape[1] - stage.p_frames)
            global_step += 1
            m = _mean_aux(aux_list)  # reads the step's results: a sync
            record["iterations"].append({
                "epoch": epoch, "it": it, "stage": stage.stage,
                **{k: m[k].tolist() for k in ("loss", "bpp", "psnr")}})
            if writer is not None:
                writer.add_metrics("train", m, lambdas, global_step)
                writer.add_scalar("train/stage", stage.stage, global_step)
                writer.add_scalar("train/lr", stage.lr * lr_scale,
                                  global_step)
            logger.info(
                "epoch %d it %d stage %d loss %.4f bpp %s psnr %s",
                epoch, it, stage.stage, float(m["loss"].mean()),
                np.round(m["bpp"], 4), np.round(m["psnr"], 2))
            t_wait = time.perf_counter()
        _sync(device)
        ep["train_s"] = time.perf_counter() - t_epoch
        ep["launches"] = {k: v - launches[k]
                          for k, v in cuda_build.LAUNCHES.items()}
        if mesh is not None:
            # the slowest rank's seconds: one frames/s on every rank
            ep["train_s"] = pm.max_over_ranks(ep["train_s"], device)

        if tracker is not None:
            tracker.write(writer, global_step)

        t = time.perf_counter()
        params, opt_state = model, opt
        if fsdp or tp:
            # a collective: every rank joins, whatever it does next
            params, opt_state = pm.host_copy(model), opt.state_dict()
        ep["checkpoint_s"] = time.perf_counter() - t
        if is_main and evaluates:
            t = time.perf_counter()
            if eval_model is not model:
                eval_model.load_state_dict(params, strict=True)
            eval_metrics = eval_dataset(
                eval_model, stage, test_loader, cfg, lambdas,
                i_frame_fn=i_frame_fn, pl_fn=pl_fn, od_loader=od_loader,
                detector_fn=detector_fn)
            ep["eval_s"] = time.perf_counter() - t
            ep["eval"] = {k: np.asarray(v).tolist()
                          for k, v in eval_metrics.items()}
            writer.add_metrics("eval", eval_metrics, lambdas, global_step)
        if is_main and checkpointer is not None:
            t = time.perf_counter()
            checkpointer.save(f"model_epoch_{epoch:03d}", params, opt_state,
                              epoch=epoch + 1)
            ep["checkpoint_s"] += time.perf_counter() - t
        record["epochs"].append(ep)
        logger.info(
            "epoch %d: %d frames in %.3f s (%.3f frames/s; loader wait "
            "%.3f s), eval %.3f s, checkpoint %.3f s", epoch, ep["frames"],
            ep["train_s"], ep["frames"] / max(ep["train_s"], 1e-9),
            ep["loader_wait_s"], ep["eval_s"], ep["checkpoint_s"])
    if own_writer:
        writer.close()
    return record
