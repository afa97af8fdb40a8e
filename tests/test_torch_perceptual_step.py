"""PyTorch port, the perceptual loss in the training objective against
the JAX package on the CPU: get_perceptual_loss on a torchvision-layout
.pth written with torch.save, which the JAX factory reads too (pl_fn
rtol 1e-4), and one single-frame step of the damped 64x64 DMC (16/16/24,
2 anchors, as tests/test_torch_train_step.py) with the ResNet-50 loss
against the JAX package's make_single_frame_step, the same noise (JAX's
draws).

In the step the port's pl_fn is get_perceptual_loss on a .pth; the JAX
pl_fn applies its FasterRCNNResNetPerceptualLoss to the same weights (a
seeded flax tree, carried into the port with state_dict_from_flax).
Tolerances: tests/test_torch_train_step.py's (loss and FrameAux rtol
1e-4, gradients read from the first moments rtol 1e-2 with 1e-2 of each
leaf's largest magnitude); the parameters after AdamW within 1e-6 + 0.05
lr where the gradient is above 4e-2 of its leaf's largest (Adam's first
step is a sign there, which both stacks share) and within 2.1 lr
elsewhere (chip_smoke.py's rule for the card's step).
"""
from __future__ import annotations

import copy
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_perceptual import (_frames, _rcnn_pth,  # noqa: F401
                                         nets)
from tests.test_torch_train_step import (CH, LAMBDAS, LR,  # noqa: F401
                                         _close_grads, _jax_mu, _named,
                                         _port_mu, _sequences, _stage,
                                         jax_noise, models)
from tests.test_torch_warp_twopass import one_torch_thread  # noqa: F401
from vcm_ts_tpu.models.dmc import make_dpb as j_make_dpb
from vcm_ts_tpu.train import losses as JL
from vcm_ts_tpu.train import train_step as jts
from vcm_ts_tpu.train.config import default_training_cfg as j_default_cfg
from vcm_ts_tpu.train.optimizer import make_stage_optimizer as j_make_opt
from vcm_ts_tpu.train.stages import StageParams as JStageParams
from vcm_ts_tpu.utils.common import tree_copy
from vcm_ts_tpu_torch.models.dmc import make_dpb
from vcm_ts_tpu_torch.train import losses as L
from vcm_ts_tpu_torch.train import train_step as ts
from vcm_ts_tpu_torch.train.optimizer import make_stage_optimizer
from vcm_ts_tpu_torch.train.stages import StageParams
from vcm_ts_tpu_torch.utils.config import default_training_cfg


def test_perceptual_single_step_matches_jax(models, nets, tmp_path):
    """make_single_frame_step with the ResNet loss (PL_LAMBDA 10, the
    default PL_LAYERS; the port's pl_fn from get_perceptual_loss on a .pth
    of the same weights) against JAX's: loss and FrameAux (p_dist > 0),
    the gradients (first moments), the parameters after AdamW."""
    jmodel, params, port0 = models
    pth = str(tmp_path / L.RCNN_WEIGHTS)
    jres, res_params, port_res = nets["resnet"]
    _rcnn_pth(port_res, pth)
    cfg = default_training_cfg()
    layers = tuple(cfg.SOLVER.PL_LAYERS)
    pl_lambda = float(cfg.SOLVER.PL_LAMBDA)
    pl = L.get_perceptual_loss(cfg, "cpu", path=pth)

    def jpl(target, decoded):
        return jres.apply(res_params, decoded, target, feature_layers=layers)

    stage_kw = _stage(perceptual_loss=True)
    seqs = _sequences(seed=6)
    x, ref = seqs[:, 1], seqs[:, 0]
    key = jax.random.PRNGKey(9)
    tx, opt_state = j_make_opt(params, "all", LR)
    jstep = jts.make_single_frame_step(jmodel, tx, JStageParams(**stage_kw),
                                       lambdas=LAMBDAS, dist_lambda=1.0,
                                       pl_lambda=pl_lambda, pl_fn=jpl)
    port = copy.deepcopy(port0)
    noise = jax_noise(key, port.noise_shapes(2, 64, 64))
    # XLA compiles and runs the JAX step outside the interpreter lock, so
    # it overlaps the port's step
    with ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(
            jstep, tree_copy(params), tree_copy(opt_state), jnp.asarray(x),
            jnp.asarray(x), j_make_dpb(jnp.asarray(ref), CH[1], CH[2]), key,
            True)
        opt = make_stage_optimizer(port, "all", LR)
        step = ts.make_single_frame_step(port, opt, StageParams(**stage_kw),
                                         lambdas=LAMBDAS, dist_lambda=1.0,
                                         pl_lambda=pl_lambda, pl_fn=pl)
        aux, _ = step(torch.from_numpy(x), torch.from_numpy(x),
                      make_dpb(torch.from_numpy(ref), CH[1], CH[2]), noise,
                      True)
        jp, jstate, jaux, _ = jax_run.result()
    for f in ts.FrameAux._fields:
        np.testing.assert_allclose(getattr(aux, f).numpy(),
                                   np.asarray(getattr(jaux, f)), rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    assert float(aux.p_dist.min()) > 0
    want_mu = _jax_mu(jstate)
    _close_grads(_port_mu(opt), want_mu)
    jnamed = _named(jp)
    for name, p in port.named_parameters():
        g = want_mu[name]
        scale = max(float(np.abs(g).max()), 1e-30)
        tol = np.where(np.abs(g) > 4e-2 * scale, 1e-6 + 0.05 * LR,
                       2.1 * LR)
        d = np.abs(p.detach().numpy() - jnamed[name])
        assert (d <= tol).all(), (name, float(d.max()))


@pytest.mark.parametrize("kind", ["resnet", "fpn"])
def test_get_perceptual_loss_reads_pth_as_jax(nets, kind, tmp_path,
                                              monkeypatch):
    """The factories of both stacks on one .pth written with torch.save
    (the JAX one reads pretrained/<name> under its working directory), the
    default PL_LAYERS: pl_fn(target, decoded) rtol 1e-4."""
    os.makedirs(tmp_path / "pretrained")
    pth = str(tmp_path / "pretrained" / L.RCNN_WEIGHTS)
    _rcnn_pth(nets["fpn"][2], pth)
    cfg = default_training_cfg()
    cfg.SOLVER.PL_MODEL = kind
    jcfg = j_default_cfg()
    jcfg.SOLVER.PL_MODEL = kind

    # the JAX factory's eager flax init of ResNet-50 only gives the tree
    # its shapes (every leaf is then read from the file): trace it instead
    def traced_init(self, *args, **kw):
        shapes = jax.eval_shape(functools.partial(type(self).__mro__[1].init,
                                                  self), *args, **kw)
        return jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), shapes)

    cls = (JL.FasterRCNNResNetPerceptualLoss if kind == "resnet"
           else JL.FasterRCNNFPNPerceptualLoss)
    monkeypatch.setattr(cls, "init", traced_init, raising=False)
    monkeypatch.chdir(tmp_path)
    jpl = JL.get_perceptual_loss(jcfg)
    pl = L.get_perceptual_loss(cfg, "cpu", path=pth)
    decoded, target = _frames(4)
    want = np.asarray(jax.jit(jpl)(jnp.asarray(target),
                                   jnp.asarray(decoded)))
    with torch.no_grad():
        got = pl(torch.from_numpy(target), torch.from_numpy(decoded))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    assert float(got.min()) > 0
    # frozen, in eval mode: nothing of the network asks for a gradient
    assert not pl.model.training
    assert not any(p.requires_grad for p in pl.model.parameters())
