"""Rank functions of the port's data-parallel and FSDP tests
(tests/test_torch_parallel.py on the CPU, tests/test_torch_parallel_cuda.py
on the card). Imports nothing of JAX: the card has none. Each function runs
in every rank of vcm_ts_tpu_torch/parallel/spawn.run_ranks (or, with no
process group, alone, as the one-process reference)."""

from __future__ import annotations

import sys

import numpy as np
import torch


def hide_tensorboard():
    """No tensorboard in a rank, as on the card: here it pulls in
    TensorFlow (about 20 s a process)."""
    sys.modules["torch.utils.tensorboard"] = None


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_np(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def _t(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def step_case(spec: dict) -> dict:
    """One train step of a DMC from spec["state"] on the global batch of
    spec: with a process group, this rank's rows (data parallel, or with
    spec["fsdp"] the model sharded first), else all rows in one process.

    spec: channels, anchors, state (a state_dict), stage (StageParams
    fields), lambdas, lr, clip, accum, device, compute_dtype (None or
    "bf16"), kind "single" (x, ref (N, H, W, 3), noise: the four global
    noise arrays) or "cascade" (xs (p, N, H, W, 3), ref, noise: per
    frame, or per group of accum, as draw_cascade_noise makes them).
    Returns FrameAux, the whole parameters and optimizer state after the
    step, the share of each parameter this rank holds and the number of
    reduce_gradients calls and all-reduces."""
    import torch.distributed as dist

    from vcm_ts_tpu_torch.models.dmc import DMC, make_dpb
    from vcm_ts_tpu_torch.parallel import mesh as pm
    from vcm_ts_tpu_torch.parallel.tensor import shard_params_fsdp
    from vcm_ts_tpu_torch.train import train_step as ts
    from vcm_ts_tpu_torch.train.optimizer import make_stage_optimizer
    from vcm_ts_tpu_torch.train.stages import StageParams

    dev = torch.device(spec.get("device", "cpu"))
    if dev.type == "cuda":
        from vcm_ts_tpu_torch.utils.device import set_codec_numerics

        set_codec_numerics()  # TF32 off, as in the caller
        dev = pm.local_device("cuda")
    cmv, cn, cm = spec["channels"]
    model = DMC(anchor_num=spec["anchors"], channel_mv=cmv, channel_N=cn,
                channel_M=cm, device=dev)
    model.load_state_dict(spec["state"], strict=True)
    dtype = {None: None, "bf16": torch.bfloat16}[spec.get("compute_dtype")]
    mesh = None
    if dist.is_initialized():
        mesh = pm.make_global_mesh(device_type=dev.type)
        pm.replicate(model, mesh)
        if spec.get("fsdp"):
            shard_params_fsdp(model, mesh, dtype)
    whole = {n: p.numel() for n, p in model.named_parameters()}
    share = {n: (p.to_local().numel() if hasattr(p, "to_local")
                 else p.numel()) / whole[n]
             for n, p in model.named_parameters()}
    counts = {"reduce_gradients": 0, "all_reduce": 0}
    reduce0, all_reduce0 = pm.reduce_gradients, dist.all_reduce

    def reduce_counted(*a, **k):
        counts["reduce_gradients"] += 1
        return reduce0(*a, **k)

    def all_reduce_counted(*a, **k):
        counts["all_reduce"] += 1
        return all_reduce0(*a, **k)

    pm.reduce_gradients, dist.all_reduce = reduce_counted, all_reduce_counted
    try:
        opt = make_stage_optimizer(model, spec["stage"]["trainable_mode"],
                                   spec["lr"], grad_clip_norm=spec["clip"])
        stage = StageParams(**spec["stage"])
        common = dict(lambdas=spec["lambdas"], dist_lambda=1.0,
                      pl_lambda=0.0, compute_dtype=dtype, mesh=mesh)
        rows = pm.global_batch if mesh is not None else (lambda v, **k: v)
        if spec["kind"] == "single":
            x = _t(rows(spec["x"]), dev)
            noise = tuple(_t(rows(v), dev) for v in spec["noise"])
            step = ts.make_single_frame_step(model, opt, stage, **common)
            aux, dpb = step(x, x, make_dpb(_t(rows(spec["ref"]), dev), cn,
                                           cm), noise, True)
        else:
            G = spec["accum"]
            xs = _t(rows(spec["xs"], batch_dim=1), dev)
            if G == 1:
                noise = [tuple(_t(rows(v), dev) for v in f)
                         for f in spec["noise"]]
            else:
                noise = [[tuple(_t(rows(v), dev) for v in f) for f in g]
                         for g in spec["noise"]]
            step = ts.make_cascade_step(model, opt, stage, accum_steps=G,
                                        **common)
            aux, dpb = step(xs, xs, make_dpb(_t(rows(spec["ref"]), dev), cn,
                                             cm), noise)
        counts_step = dict(counts)
    finally:
        pm.reduce_gradients, dist.all_reduce = reduce0, all_reduce0
    return {"aux": {f: _np(getattr(aux, f)) for f in ts.FrameAux._fields},
            "ref_frame": _np(dpb["ref_frame"]),
            "params": _np(pm.host_copy(model)),
            "opt": _np(opt.state_dict()), "share": share,
            "counts": counts_step}


def trainer_case(jobs: list) -> list:
    """python -m vcm_ts_tpu_torch.trainer_multi's main for each argv of
    jobs in turn, in this rank: their records."""
    hide_tensorboard()
    from vcm_ts_tpu_torch import trainer_multi

    return [trainer_multi.main(argv) for argv in jobs]


def video_case(argv: list) -> dict:
    """python -m vcm_ts_tpu_torch.test_video's main in this rank."""
    from vcm_ts_tpu_torch import test_video

    return test_video.main(argv)


def steps_case(specs: list) -> list:
    """step_case of each spec in turn, in this rank."""
    return [step_case(s) for s in specs]
