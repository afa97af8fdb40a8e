"""The training slice on the card: kernels A' and C' against their plain
versions, the autograd paths of A, B and C on CUDA tensors, and a cascade
train step on the card against the same step on the CPU.

Needs a CUDA device and nvcc, so every test carries the `cuda` marker and
skips without a card. Imports no JAX (run on the card with --noconftest):

    python -m pytest tests/test_torch_train_cuda.py -q -m cuda --noconftest

Tolerances: C' is a permutation, bit-identical. A': d flow sums in a fixed
order other than the plain version's, d im through f32 atomics in an order
that changes from run to run (many taps collapse onto the border pixels
under a flow that reaches past it): f32 within 1e-5 (d flow) and 1e-4
(d im) of the largest magnitude; bf16 (both cast an f32 sum once) within
one bf16 ulp of the largest magnitude. The train step: cuDNN's convs against
the CPU's, f32 without TF32: FrameAux rtol 1e-3, gradients (the optimizer's
first moments) within 2e-2 of each leaf's largest magnitude.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from vcm_ts_tpu_torch.models.dmc import DMC, make_dpb
from vcm_ts_tpu_torch.ops import cuda_build
from vcm_ts_tpu_torch.ops import subpel as ts
from vcm_ts_tpu_torch.ops import warp as tw
from vcm_ts_tpu_torch.train import train_step as tts
from vcm_ts_tpu_torch.train.optimizer import make_stage_optimizer
from vcm_ts_tpu_torch.train.stages import StageParams
from vcm_ts_tpu_torch.utils.device import set_codec_numerics
from vcm_ts_tpu_torch.utils.weights import init_params

CL = torch.channels_last


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cuda_build.build_all()
    set_codec_numerics()
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(shape, g, dtype=torch.float32):
    return torch.randn(shape, device="cuda", generator=g).to(
        dtype=dtype, memory_format=CL)


def _tol(want, dtype, f32_rel):
    scale = float(want.float().abs().max())
    return (f32_rel if dtype == torch.float32 else 2.0 ** -7) * scale


def _flow(kind, n, h, w, g):
    if kind == "zero":
        return torch.zeros((n, 2, h, w), device="cuda").contiguous(
            memory_format=CL)
    std = 8.0 if kind == "iid" else 3.0 * max(h, w)
    return _randn((n, 2, h, w), g) * std


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["iid", "zero", "beyond"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chans", [(3,), (2,), (64,), (3, 64)])
def test_warp_bwd_kernel_matches_plain(gen, chans, dtype, kind):
    n, h, w = 2, 37, 61
    ims = [_randn((n, c, h, w), gen, dtype) for c in chans]
    gs = [_randn((n, c, h, w), gen, dtype) for c in chans]
    flow = _flow(kind, n, h, w, gen).to(dtype)
    for need_im in (True, False):
        dflow, dims = tw.warp_backward_cuda(ims, flow, gs, need_im)
        wflow, wims = tw.warp_backward_plain(ims, flow, gs, need_im)
        assert dflow.dtype == flow.dtype and dflow.shape == flow.shape
        err = float((dflow.float() - wflow.float()).abs().max())
        assert err <= _tol(wflow, dtype, 1e-5), (need_im, err)
        for d, wd in zip(dims, wims):
            if not need_im:
                assert d is None and wd is None
                continue
            assert d.dtype == dtype and d.is_contiguous(memory_format=CL)
            err = float((d.float() - wd.float()).abs().max())
            assert err <= _tol(wd, dtype, 1e-4), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 32, 3, 1])
def test_space_to_depth_kernel_bit_identical_to_plain(gen, dtype, c):
    g = _randn((2, c, 38, 50), gen, dtype)
    got = ts.space_to_depth_cuda(g, 2)
    torch.testing.assert_close(got, ts.space_to_depth_plain(g, 2), rtol=0,
                               atol=0)
    torch.testing.assert_close(ts.relayout_cuda(got, 2), g, rtol=0, atol=0)


@pytest.mark.cuda
def test_autograd_on_cuda_goes_through_the_kernels(gen):
    """Warp, relayout and the fused 1x1 conv on CUDA leaves: backward
    launches A' and C' (never a plain backward) and agrees with the same
    graph on the CPU."""
    im = _randn((2, 16, 20, 24), gen).requires_grad_()
    flow = (_randn((2, 2, 20, 24), gen) * 3).requires_grad_()
    x = _randn((2, 32, 10, 12), gen).requires_grad_()
    wk = (torch.randn((4, 32, 8), device="cuda", generator=gen) / 6
          ).requires_grad_()
    bk = torch.randn((4, 8), device="cuda", generator=gen).requires_grad_()

    def loss(im, flow, x, wk, bk):
        a = tw.flow_warp(im, flow)
        b = ts.pixel_shuffle_relayout(
            torch.cat([x, x], 1).contiguous(memory_format=CL), 2)
        c = ts.subpel_conv1x1(x, wk, bk, 2)
        return (a ** 2).sum() + (b * b.flip(1)).sum() + (c ** 3).sum()

    cuda_build.reset_launches()
    gpu = torch.autograd.grad(loss(im, flow, x, wk, bk),
                              (im, flow, x, wk, bk))
    torch.cuda.synchronize()
    for k in ("warp", "warp_bwd", "pixel_shuffle_relayout", "subpel_conv1x1"):
        assert cuda_build.LAUNCHES[k] == 1, (k, cuda_build.LAUNCHES)
    assert cuda_build.LAUNCHES["space_to_depth"] == 2
    leaves = [t.detach().cpu().requires_grad_() for t in
              (im, flow, x, wk, bk)]
    cpu = torch.autograd.grad(loss(*leaves), leaves)
    for a, b in zip(gpu, cpu):
        scale = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_cascade_step_card_against_cpu(gen):
    """One cascade step (p_frames 2, remat) of a seeded DMC at 64x64, the
    same noise, on the CPU (plain versions) and on the card (kernels)."""
    model = init_params(DMC(anchor_num=2, channel_mv=16, channel_N=16,
                            channel_M=24, device="cpu"), seed=0,
                        kernel_scale=0.5)
    rng = np.random.default_rng(0)
    seq = torch.from_numpy(rng.random((3, 2, 64, 64, 3)).astype(np.float32))
    noises = tts.draw_cascade_noise(model, seq[1:],
                                    torch.Generator().manual_seed(1))
    stage = StageParams(stage=0, p_frames=2, trainable_mode="all",
                        forward_method="cascade", loss_dist_key="mse",
                        loss_rate_keys=("bpp_mv_y", "bpp_mv_z", "bpp_y",
                                        "bpp_z"), lr=1e-4,
                        perceptual_loss=False)
    out = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        opt = make_stage_optimizer(m, "all", 1e-4)
        step = tts.make_cascade_step(m, opt, stage, lambdas=[85.0, 170.0],
                                     dist_lambda=1.0, pl_lambda=0.0)
        cuda_build.reset_launches()
        xs = seq[1:].to(dev)
        aux, dpb = step(xs, xs, make_dpb(seq[0].to(dev), 16, 24),
                        [tuple(t.to(dev) for t in n) for n in noises])
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(cuda_build.LAUNCHES)
        out[dev] = (aux, {k: v.cpu() for k, v in opt.mu.items()})
    for k in ("warp", "warp_bwd", "subpel_conv1x1", "pixel_shuffle_relayout",
              "space_to_depth"):
        assert launches[k] > 0, launches
    assert launches["warp_twopass"] == 0
    for f in tts.FrameAux._fields:
        np.testing.assert_allclose(getattr(out["cuda"][0], f).cpu().numpy(),
                                   getattr(out["cpu"][0], f).numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=f)
    for k, want in out["cpu"][1].items():
        got = out["cuda"][1][k]
        scale = max(float(want.abs().max()), 1e-30)
        assert float((got - want).abs().max()) <= 2e-2 * scale, k
