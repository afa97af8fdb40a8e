"""DCVC_HEM: the reference-style training wrapper over the DMC.

The port's counterpart of vcm_ts_tpu/models/wrapper.py: one object owning
the DMC, the lambda vectors, the perceptual loss and the string-dispatched
forward methods ('single', 'cascade', 'single_multi', 'cascade_multi',
'forward_simple'). The five activate_modules_* methods pick the trainable
set, which rebuilds the stage optimizer (fresh moments), as the JAX
wrapper swaps its optax mask. Training noise comes from the wrapper's own
torch.Generator (seed 1).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..train.optimizer import make_stage_optimizer
from ..train.stages import StageParams
from ..train.train_step import (detach_tree, draw_noise, frame_loss,
                                make_cascade_step, make_single_frame_step,
                                run_cascade_sequence, run_single_sequence,
                                to_f32)
from ..utils.device import resolve_device
from ..utils.weights import init_params
from .dmc import DMC, make_dpb


def _stack(aux_list, field):
    return np.stack([getattr(a, field).cpu().numpy() for a in aux_list], -1)


class DCVC_HEM:
    def __init__(self, cfg, model: Optional[DMC] = None, pl_fn=None,
                 device="cuda", seed: int = 0):
        self.cfg = cfg
        cmv, cn, cm = cfg.MODEL.CHANNELS
        self.device = resolve_device(device)
        if model is None:
            model = init_params(DMC(anchor_num=len(cfg.SOLVER.LAMBDAS),
                                    channel_mv=cmv, channel_N=cn,
                                    channel_M=cm, device=self.device), seed)
        self.dmc = model
        self.lambdas = [float(v) for v in cfg.SOLVER.LAMBDAS]
        self.pl_lambda = float(cfg.SOLVER.PL_LAMBDA)
        self.dist_lambda = float(cfg.SOLVER.DIST_LAMBDA)
        self.perceptual_loss = pl_fn
        self._mode = "all"
        self._lr = float(cfg.SOLVER.LR)
        self._opt = None
        self._step_cache = {}
        self._gen = torch.Generator(device=self.device).manual_seed(1)

    # ------------------------------------------------- module activation
    def _activate(self, mode: str):
        if mode != self._mode or self._opt is None:
            self._mode = mode
            self._opt = make_stage_optimizer(self.dmc, mode, self._lr)
            self._step_cache.clear()

    def activate_modules_inter_dist(self):
        self._activate("inter_dist")

    def activate_modules_inter_dist_rate(self):
        self._activate("inter_dist_rate")

    def activate_modules_recon_dist(self):
        self._activate("recon_dist")

    def activate_modules_recon_dist_rate(self):
        self._activate("recon_dist_rate")

    def activate_modules_all(self):
        self._activate("all")

    def set_lr(self, lr: float):
        if lr != self._lr:
            self._lr = lr
            self._opt = None
            self._activate(self._mode)

    # ------------------------------------------------------------ dispatch
    def forward(self, forward_method: str, input, target=None,
                loss_dist_key: Optional[str] = None,
                loss_rate_keys: Optional[Sequence[str]] = None,
                p_frames: Optional[int] = None,
                perceptual_loss: Optional[bool] = None,
                is_train: bool = True, dpb=None, t_i=None,
                i_frame_net=None, i_frame_q_scales=None,
                is_first_p: bool = True):
        """The reference's dispatch. `input`/`target` are (N, T, H, W, 3)
        arrays (N, H, W, 3 for forward_simple); `i_frame_net` any callable
        mapping a frame batch to its reference frames. For the *_multi
        variants the caller owns the DPB chaining and passes
        is_first_p=False for a DPB from an earlier P-frame; their
        "loss_to_opt" keeps its graph for the caller's backward."""
        if forward_method in ("single", "cascade"):
            return self._run(forward_method, input, target, loss_dist_key,
                             loss_rate_keys, p_frames, perceptual_loss,
                             is_train, i_frame_net)
        if forward_method in ("single_multi", "cascade_multi"):
            return self._frame_losses(input, target, loss_dist_key,
                                      loss_rate_keys, dpb, perceptual_loss,
                                      forward_method, p_frames, t_i,
                                      is_first_p)
        if forward_method == "forward_simple":
            return self.forward_simple(input, dpb, is_first_p=is_first_p)
        raise ValueError(f"unknown forward method: {forward_method}")

    __call__ = forward

    def _stage(self, method, dist_key, rate_keys, p_frames, pl):
        return StageParams(stage=0, p_frames=p_frames or 1,
                           trainable_mode=self._mode,
                           forward_method=method,
                           loss_dist_key=dist_key or "mse",
                           loss_rate_keys=tuple(rate_keys or ()),
                           lr=self._lr, perceptual_loss=bool(pl))

    def _loss_kw(self, stage, pl):
        return dict(lambdas=torch.tensor(self.lambdas, device=self.device),
                    dist_lambda=self.dist_lambda, pl_lambda=self.pl_lambda,
                    loss_rate_keys=stage.loss_rate_keys,
                    loss_dist_key=stage.loss_dist_key,
                    pl_fn=self.perceptual_loss if pl else None)

    @staticmethod
    def _result(aux_list):
        out = {k: _stack(aux_list, k)
               for k in ("rate", "dist", "p_dist", "loss")}
        out["single_forwards"] = len(aux_list)
        return out

    def _run(self, method, inputs, targets, dist_key, rate_keys, p_frames,
             pl, is_train, i_frame_fn):
        stage = self._stage(method, dist_key, rate_keys, p_frames, pl)
        if not is_train:
            return self._run_eval(stage, inputs, targets, pl, i_frame_fn)
        self._activate(self._mode)
        key = (method, stage.loss_dist_key, stage.loss_rate_keys,
               stage.p_frames, bool(pl))
        if key not in self._step_cache:
            maker = (make_single_frame_step if method == "single"
                     else make_cascade_step)
            self._step_cache[key] = maker(
                self.dmc, self._opt, stage, lambdas=self.lambdas,
                dist_lambda=self.dist_lambda, pl_lambda=self.pl_lambda,
                pl_fn=self.perceptual_loss if pl else None)
        runner = (run_single_sequence if method == "single"
                  else run_cascade_sequence)
        aux_list = runner(self.dmc, self._step_cache[key], inputs, targets,
                          stage, self._gen, i_frame_fn=i_frame_fn)
        return self._result(aux_list)

    @torch.no_grad()
    def _run_eval(self, stage, inputs, targets, pl, i_frame_fn):
        """Eval: rounding quantization, no gradient, no optimizer (the
        reference's is_train=False)."""
        kw = self._loss_kw(stage, pl)
        t = inputs.shape[1]
        aux_list = []
        for t_i in range(t - stage.p_frames):
            ref = (i_frame_fn(inputs[:, t_i]) if i_frame_fn is not None
                   else inputs[:, t_i])
            dpb = make_dpb(self._tensor(ref), self.dmc.channel_N,
                           self.dmc.channel_M)
            for p_idx in range(stage.p_frames):
                _, (aux, dpb) = frame_loss(
                    self.dmc, self._tensor(inputs[:, t_i + 1 + p_idx]),
                    self._tensor(targets[:, t_i + 1 + p_idx]), dpb,
                    noise=None, is_first_p=p_idx == 0, training=False, **kw)
                aux_list.append(aux)
        return self._result(aux_list)

    def _tensor(self, v):
        return to_f32(v, self.device)

    def _frame_losses(self, inputs, targets, dist_key, rate_keys, dpb, pl,
                      method, p_frames, t_i, is_first_p=True):
        """*_multi variants: the loss only; the optimizer step stays with
        the caller."""
        stage = self._stage(method, dist_key, rate_keys, p_frames, pl)
        kw = self._loss_kw(stage, pl)
        if method == "single_multi":
            x = self._tensor(inputs)
            _, (aux, new_dpb) = frame_loss(
                self.dmc, x, self._tensor(targets), dpb,
                noise=draw_noise(self.dmc, x, self._gen),
                is_first_p=is_first_p, **kw)
            return {"loss": aux.loss, "loss_to_opt": aux.loss.mean(),
                    "rate": aux.rate, "dist": aux.dist, "p_dist": aux.p_dist,
                    "dpb": detach_tree(new_dpb)}
        t_i = t_i or 0
        auxes = []
        cur = dpb
        for p_idx in range(stage.p_frames):
            x = self._tensor(inputs[:, t_i + 1 + p_idx])
            _, (aux, cur) = frame_loss(
                self.dmc, x, self._tensor(targets[:, t_i + 1 + p_idx]), cur,
                noise=draw_noise(self.dmc, x, self._gen),
                is_first_p=p_idx == 0, **kw)
            auxes.append(aux)

        def mean(field):
            return torch.stack([getattr(a, field) for a in auxes], -1).mean(-1)

        loss = mean("loss")
        return {"loss": loss, "loss_to_opt": loss.mean(),
                "rate": mean("rate"), "dist": mean("dist"),
                "p_dist": mean("p_dist"), "dpb": cur}

    @torch.no_grad()
    def forward_simple(self, inputs, dpbs, is_first_p=False):
        """Per-rate DPB chaining: inputs (N, H, W, 3), dpbs one DPB per rate
        row; is_first_p for the first P-frame after an I-frame."""
        mv_qs, y_qs = self.dmc.mv_y_q_scale, self.dmc.y_q_scale
        out = []
        for i, dpb in enumerate(dpbs):
            res = self.dmc(self._tensor(inputs[i:i + 1]), dpb,
                           mv_qs[i:i + 1], y_qs[i:i + 1], is_first_p)
            out.append(res["dpb"])
        return out
