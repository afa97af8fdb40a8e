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
    "bf16"), fsdp, or tp (the model axis's size: a data x model mesh of
    the world, the model split by shard_params_tp), kind "single" (x, ref (N, H, W, 3), noise: the four global
    noise arrays) or "cascade" (xs (p, N, H, W, 3), ref, noise: per
    frame, or per group of accum, as draw_cascade_noise makes them).
    Returns FrameAux, the whole parameters and optimizer state after the
    step, the share of each parameter this rank holds, the number of
    reduce_gradients calls and all-reduces, and under tp the number of
    split parameters and the gradients of the whole (unsplit) ones before
    the model group's broadcast."""
    import torch.distributed as dist

    from vcm_ts_tpu_torch.models.dmc import DMC, make_dpb
    from vcm_ts_tpu_torch.parallel import mesh as pm
    from vcm_ts_tpu_torch.parallel.tensor import (shard_params_fsdp,
                                                  shard_params_tp,
                                                  split_params)
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
    mesh, n_split = None, 0
    if dist.is_initialized() and spec.get("tp"):
        mesh = pm.make_dp_tp_mesh(pm.get_world_size() // spec["tp"],
                                  spec["tp"], device_type=dev.type)
        n_split = shard_params_tp(pm.replicate(model), mesh)
    elif dist.is_initialized():
        mesh = pm.make_global_mesh(device_type=dev.type)
        pm.replicate(model, mesh)
        if spec.get("fsdp"):
            shard_params_fsdp(model, mesh, dtype)
    split = split_params(model)
    whole = {n: p.numel() * (split[n].size if n in split else 1)
             for n, p in model.named_parameters()}
    share = {n: (p.to_local().numel() if hasattr(p, "to_local")
                 else p.numel()) / whole[n]
             for n, p in model.named_parameters()}
    counts = {"reduce_gradients": 0, "all_reduce": 0}
    reduce0, all_reduce0 = pm.reduce_gradients, dist.all_reduce

    whole_grads = {}

    def reduce_counted(*a, **k):
        counts["reduce_gradients"] += 1
        grads = reduce0(*a, **k)
        # the whole parameters' gradients as this rank computed them,
        # before the model group's broadcast
        whole_grads.update({n: g.detach().cpu().clone()
                            for n, g in grads.items()
                            if g is not None and n not in split})
        return grads

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
        rows = ((lambda v, **k: pm.global_batch(v, mesh, **k))
                if mesh is not None else (lambda v, **k: v))
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
            "counts": counts_step, "n_split": n_split,
            "whole_grads": _np(whole_grads) if split else {}}


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


def tp_forward_case(spec: dict) -> dict:
    """The forwards of a DMC and an IntraNoAR split over every rank
    (a 1 x world data x model mesh, parallel/tensor.shard_params_tp): the
    DMC through tp_forward (is_first_p, q-scales 1) on spec["x"] /
    spec["ref"], the IntraNoAR on spec["ix"] (q-scale 1); with no process
    group, the whole models. spec: dmc (channels, anchors, state), intra
    (N, anchors, state), x, ref, ix (NHWC arrays), device. Returns each
    model's outputs, its number of split parameters and the bytes of
    parameters this rank holds against the whole model's."""
    import torch.distributed as dist

    from vcm_ts_tpu_torch.models.dmc import DMC, make_dpb
    from vcm_ts_tpu_torch.models.intra import IntraNoAR
    from vcm_ts_tpu_torch.parallel import mesh as pm
    from vcm_ts_tpu_torch.parallel import tensor as tp

    dev = torch.device(spec.get("device", "cpu"))
    if dev.type == "cuda":
        from vcm_ts_tpu_torch.utils.device import set_codec_numerics

        set_codec_numerics()
        dev = pm.local_device("cuda")
    cmv, cn, cm = spec["dmc"]["channels"]
    dmc = DMC(anchor_num=spec["dmc"]["anchors"], channel_mv=cmv,
              channel_N=cn, channel_M=cm, device=dev)
    intra = IntraNoAR(N=spec["intra"]["N"],
                      anchor_num=spec["intra"]["anchors"], device=dev)
    out = {}
    mesh = None
    if dist.is_initialized():
        mesh = pm.make_dp_tp_mesh(1, pm.get_world_size(),
                                  device_type=dev.type)
    for name, model in (("dmc", dmc), ("intra", intra)):
        model.load_state_dict(spec[name]["state"], strict=True)
        whole = sum(p.numel() * p.element_size() for p in model.parameters())
        n_split = 0
        if mesh is not None:
            n_split = tp.shard_params_tp(model, mesh)
            assert tp.assert_params_sharded(model) == n_split
        out[name] = {"n_split": n_split, "whole_bytes": whole,
                     "rank_bytes": sum(p.numel() * p.element_size()
                                       for p in model.parameters())}
    x, ref, ix = (_t(spec[k], dev) for k in ("x", "ref", "ix"))
    dpb = make_dpb(ref, cn, cm)
    if mesh is not None:
        fwd = tp.tp_forward(dmc, mesh, is_first_p=True)
    else:
        def fwd(*args):
            with torch.no_grad():
                return dmc(*args, True, training=False)
    res = fwd(x, dpb, 1.0, 1.0)
    out["dmc"].update(ref_frame=_np(res["dpb"]["ref_frame"]),
                      bpp=_np(res["bpp"]))
    with torch.no_grad():
        res = intra(ix, torch.ones((1, 1, 1, 1), device=dev))
    out["intra"].update(x_hat=_np(res["x_hat"]), bpp=_np(res["bpp"]))
    return out


def tp_jobs(spec: dict, trainer_jobs: list) -> dict:
    """In this rank: tp_forward_case(spec); then whether
    make_global_dp_tp_mesh refuses a model axis the world size does not
    divide (its message); then trainer_multi's main for each argv of
    trainer_jobs (trainer_case)."""
    from vcm_ts_tpu_torch.parallel import mesh as pm

    out = {"forward": tp_forward_case(spec)}
    try:
        pm.make_global_dp_tp_mesh(pm.get_world_size() + 1, "cpu")
        out["mesh_error"] = None
    except ValueError as e:
        out["mesh_error"] = str(e)
    out["trainer"] = trainer_case(trainer_jobs)
    return out
