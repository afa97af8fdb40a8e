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


# --------------------------------------------------------- spatial sharding
def _spatial_codecs(spec, dev):
    """An IntraNoAR and a DMC codec from spec's states, tables built."""
    from vcm_ts_tpu_torch.codec.engine import IntraCodec, VideoCodec
    from vcm_ts_tpu_torch.models.dmc import DMC
    from vcm_ts_tpu_torch.models.intra import IntraNoAR

    intra = IntraNoAR(N=spec["intra"]["N"],
                      anchor_num=spec["intra"]["anchors"], device=dev)
    intra.load_state_dict(spec["intra"]["state"], strict=True)
    cmv, cn, cm = spec["dmc"]["channels"]
    dmc = DMC(anchor_num=spec["dmc"]["anchors"], channel_mv=cmv,
              channel_N=cn, channel_M=cm, device=dev)
    dmc.load_state_dict(spec["dmc"]["state"], strict=True)
    codecs = IntraCodec(intra, device=dev), VideoCodec(dmc, device=dev)
    for c in codecs:
        c.update()
    return codecs


def spatial_codec_case(spec: dict) -> dict:
    """The engines' spatial mode on every rank of the world (or, with no
    process group, unsharded in one process): an I-frame, then P-frames
    1 and 2 chained from make_dpb(frames[0]), each decoded back, with the
    collectives of each call. spec: intra (N, anchors, state), dmc
    (channels, anchors, state), frames (NHWC numpy, whole), h, w, iq, pq,
    device, p_frames (1 or 2),
    gop (also encode_gop / decode_gop of the P-frames), batch (also an
    I-frame compress_batch / decompress_batch of frames 0 and 1 at q
    rows batch_q). Returns the streams, the decoded frames gathered
    whole, the encoder's recons, the planes kept whole on this rank
    (hooked: the mv hyper encoder's H/32 and H/64 outputs), this rank's
    rows of frames[0] and of a small plane through spatial_shard_tree,
    the engines' entropy-estimated forwards (the I-frame, P-frame 1) and
    the collectives of each call."""
    import torch.distributed as dist

    from vcm_ts_tpu_torch.models.dmc import make_dpb
    from vcm_ts_tpu_torch.parallel import mesh as pm
    from vcm_ts_tpu_torch.parallel import spatial as sp

    dev = torch.device(spec.get("device", "cpu"))
    if dev.type == "cuda":
        dev = pm.local_device("cuda")
    ic, vc = _spatial_codecs(spec, dev)
    h, w, iq, pq = spec["h"], spec["w"], spec["iq"], spec["pq"]
    frames = [np.asarray(f, np.float32) for f in spec["frames"]]
    mesh = None
    if dist.is_initialized():
        mesh = sp.make_spatial_mesh(device_type=dev.type)
        ic.set_spatial_sharding(mesh)
        vc.set_spatial_sharding(mesh)

    def whole(tree):
        return tree if mesh is None else sp.gather_spatial(tree, mesh, h, w)

    out = {"collectives": {}}

    def counted(name, fn):
        sp.reset_collectives()
        res = fn()
        out["collectives"][name] = dict(sp.COLLECTIVES)
        return res

    hooked = {}
    hyper = vc.model.mv_hyper_prior_encoder
    hooks = [hyper[i].register_forward_hook(
        lambda m, a, o, i=i: hooked.__setitem__(i, o.detach().cpu()))
        for i in (6, 8)]
    i_stream = counted("I encode", lambda: ic.compress(frames[0], iq))
    rec0 = counted("I decode", lambda: ic.decompress(i_stream, h, w, iq))
    out["i_stream"], out["i_recon"] = i_stream, _np(whole(rec0))
    dpb0 = vc.spatial_shard_tree(make_dpb(torch.from_numpy(frames[0]),
                                          vc.model.channel_N,
                                          vc.model.channel_M))
    dpb0 = {k: v.to(dev) for k, v in dpb0.items()}
    enc, dec, dpb_e, dpb_d = [], [], dpb0, dpb0
    for t in range(1, spec.get("p_frames", 2) + 1):
        e = counted(f"P{t} encode", lambda: vc.compress(
            frames[t], dpb_e, pq, pq, t == 1))
        d = counted(f"P{t} decode", lambda: vc.decompress(
            dpb_d, e["bit_stream"], h, w, pq, pq, t == 1))
        dpb_e, dpb_d = e["dpb"], d["dpb"]
        enc.append({"stream": e["bit_stream"],
                    "recon": _np(whole(e["dpb"]["ref_frame"]))})
        dec.append(_np(whole(d["dpb"]["ref_frame"])))
        if t == 1:
            out["whole_planes"] = {k: _np(v) for k, v in hooked.items()}
    for hook in hooks:
        hook.remove()
    out["p_enc"], out["p_dec"] = enc, dec
    est_i = ic.forward(frames[0], iq)
    est_p = vc.forward(frames[1], dpb0, pq, pq, True)
    out["forward"] = {"i_bpp": _np(est_i["bpp"]),
                      "x_hat": _np(whole(est_i["x_hat"])),
                      "p_bpp": _np(est_p["bpp"]),
                      "ref_frame": _np(whole(est_p["dpb"]["ref_frame"]))}
    if spec.get("gop"):
        streams, last = vc.encode_gop(frames[1:len(enc) + 1], dpb0, pq, pq,
                                      True)
        outs, _ = vc.decode_gop(dpb0, streams, h, w, pq, pq, True)
        out["gop"] = {"streams": streams,
                      "enc_recon": _np(whole(last["ref_frame"])),
                      "dec": [_np(whole(o)) for o in outs]}
    if spec.get("batch"):
        q = np.asarray(spec["batch_q"], np.float32).reshape(-1, 1, 1, 1)
        xb = np.concatenate(frames[:2])
        streams = ic.compress_batch(xb, q)
        recons = ic.decompress_batch(streams, h, w, q)
        alone = [ic.compress(frames[i], float(q[i, 0, 0, 0]))
                 for i in range(2)]
        out["batch"] = {"streams": streams, "alone": alone,
                        "recon": _np(whole(recons))}
    if mesh is not None:
        small = np.zeros((1, h // 64, w // 64, 2), np.float32)
        rows = vc.spatial_shard_tree({"x": frames[0], "small": small})
        out["shard"] = _np(rows)
    return out


def spatial_forward_case(spec: dict) -> dict:
    """spatial_forward of a DMC (is_first_p, q-scales 1) on every rank of
    the world, or the unsharded forward in one process, on the CPU: spec
    dmc (channels, anchors, state), x, ref (NHWC numpy, whole). Returns
    ref_frame gathered whole, bpp, and the collectives."""
    import torch.distributed as dist

    from vcm_ts_tpu_torch.models.dmc import DMC, make_dpb
    from vcm_ts_tpu_torch.parallel import spatial as sp

    dev = torch.device("cpu")
    cmv, cn, cm = spec["dmc"]["channels"]
    model = DMC(anchor_num=spec["dmc"]["anchors"], channel_mv=cmv,
                channel_N=cn, channel_M=cm, device=dev).eval()
    model.load_state_dict(spec["dmc"]["state"], strict=True)
    x = _t(spec["x"], dev)
    dpb = make_dpb(_t(spec["ref"], dev), cn, cm)
    sp.reset_collectives()
    if not dist.is_initialized():
        with torch.no_grad():
            res = model(x, dpb, 1.0, 1.0, True, training=False)
        return {"ref_frame": _np(res["dpb"]["ref_frame"]),
                "bpp": _np(res["bpp"])}
    mesh = sp.make_spatial_mesh(device_type="cpu")
    sp.shard_spatial_model(sp.replicate(model, mesh), mesh)
    fwd = sp.spatial_forward(model, mesh, is_first_p=True)
    res = fwd(sp.shard_spatial(x, mesh), sp.shard_spatial_dpb(dpb, mesh),
              1.0, 1.0)
    _, h, w, _ = spec["x"].shape
    return {"ref_frame": _np(sp.gather_spatial(res["dpb"]["ref_frame"], mesh,
                                               h, w)),
            "bpp": _np(res["bpp"]), "collectives": dict(sp.COLLECTIVES)}


def spatial_jobs(codec_spec: dict, forward_spec: dict) -> dict:
    """In this rank: spatial_codec_case, then spatial_forward_case."""
    return {"codec": spatial_codec_case(codec_spec),
            "forward": spatial_forward_case(forward_spec)}
