"""The training slice on the card: kernels A', C' and E' against their
plain versions, the autograd paths of A, B and C on CUDA tensors, a
cascade train step on the card against the same step on the CPU, and two
cascade steps from one state giving the same parameters bit for bit.

Needs a CUDA device and nvcc, so every test carries the `cuda` marker and
skips without a card. Imports no JAX (run on the card with --noconftest):

    python -m pytest tests/test_torch_train_cuda.py -q -m cuda --noconftest

Tolerances: C' is a permutation, bit-identical. A': d flow and d im sum
in fixed orders other than the plain version's, so three calls give the
same bits, and many taps collapse onto the border pixels under a flow
that reaches past it, or onto one pixel under converging motion: f32
within 1e-5 (d flow) and 1e-4 (d im) of the largest magnitude; bf16
(both cast an f32 sum once) within one bf16 ulp of the largest
magnitude. E': f32 within 1e-5 of the largest magnitude of the plain
version (which sums in float64 and rounds once; E' sums in f32), bf16
one bf16 ulp, float64 1e-12; two calls give the same bits. The train step: cuDNN's
convs against the CPU's, f32 without TF32: FrameAux rtol 1e-3, gradients
(the optimizer's first moments) within 2e-2 of each leaf's largest
magnitude.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from vcm_ts_tpu_torch.models.dmc import DMC, make_dpb
from vcm_ts_tpu_torch.ops import cuda_build
from vcm_ts_tpu_torch.ops import resize as rs
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
    """iid N(0, 8^2); zero; beyond the border (N(0, (3 max(h, w))^2));
    converge: every output onto one interior pixel (a third across, half
    down, at a fraction), or onto the bottom-right corner: one segment of
    h * w outputs a plane, longer than A''s chunk."""
    if kind == "zero":
        return torch.zeros((n, 2, h, w), device="cuda").contiguous(
            memory_format=CL)
    if kind.startswith("converge"):
        ty, tx = ((h - 1.0, w - 1.0) if kind == "converge_corner"
                  else (h // 2 + 0.5, w // 3 + 0.25))
        ys = torch.arange(h, device="cuda", dtype=torch.float32)
        xs = torch.arange(w, device="cuda", dtype=torch.float32)
        f = torch.stack([(tx - xs)[None, :].expand(h, w),
                         (ty - ys)[:, None].expand(h, w)])
        return f[None].repeat(n, 1, 1, 1).contiguous(memory_format=CL)
    std = 8.0 if kind == "iid" else 3.0 * max(h, w)
    return _randn((n, 2, h, w), g) * std


def _check_warp_bwd(ims, flow, gs, need_im=True):
    """A' against warp_backward_plain at the tolerances above; three calls
    give the same d flow and d im bit for bit."""
    dflow, dims = tw.warp_backward_cuda(ims, flow, gs, need_im)
    for _ in range(2):
        again_flow, again_ims = tw.warp_backward_cuda(ims, flow, gs, need_im)
        assert torch.equal(dflow, again_flow)
        for d, a in zip(dims, again_ims):
            assert (d is None and a is None) or torch.equal(d, a)
    wflow, wims = tw.warp_backward_plain(ims, flow, gs, need_im)
    assert dflow.dtype == flow.dtype and dflow.shape == flow.shape
    err = float((dflow.float() - wflow.float()).abs().max())
    assert err <= _tol(wflow, ims[0].dtype, 1e-5), err
    if not need_im:
        assert dims == [None] * len(ims)
        return dflow, dims
    for d, wd in zip(dims, wims):
        assert d.dtype == wd.dtype and d.shape == wd.shape
        err = float((d.float() - wd.float()).abs().max())
        assert err <= _tol(wd, ims[0].dtype, 1e-4), err
    return dflow, dims


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["iid", "zero", "beyond", "converge",
                                  "converge_corner"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chans", [(3,), (2,), (64,), (3, 64)])
def test_warp_bwd_kernel_matches_plain(gen, chans, dtype, kind):
    """Odd 37x61 planes, N = 2; with and without d im."""
    n, h, w = 2, 37, 61
    ims = [_randn((n, c, h, w), gen, dtype) for c in chans]
    gs = [_randn((n, c, h, w), gen, dtype) for c in chans]
    flow = _flow(kind, n, h, w, gen).to(dtype)
    for need_im in (True, False):
        _, dims = _check_warp_bwd(ims, flow, gs, need_im)
        for d in dims if need_im else ():
            assert d.is_contiguous(memory_format=CL)


def _at_offset(t, offset):
    """t as an NHWC-dense view that starts `offset` elements into a larger
    buffer (offset 1: its pointer is not 16-byte aligned)."""
    n, c, h, w = t.shape
    buf = torch.empty(t.numel() + offset, device=t.device, dtype=t.dtype)
    v = buf[offset:].view(n, h, w, c).permute(0, 3, 1, 2)
    v.copy_(t)
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chans", [(12,), (40,), (8, 3, 16), (6,)])
def test_warp_bwd_units_and_alignment(gen, chans, dtype, offset):
    """A tensor whose pixel row is a whole number of 16-byte units and
    whose pointers are aligned is read in units (G lanes sized by the
    widest tensor's units, some idle: 40 bf16 channels are 5 units of 8
    lanes); any other goes channel by channel, also beside tensors read
    in units. Both agree with the plain version, N = 2 at 21x33."""
    n, h, w = 2, 21, 33
    ims = [_at_offset(_randn((n, c, h, w), gen, dtype), offset)
           for c in chans]
    gs = [_at_offset(_randn((n, c, h, w), gen, dtype), offset)
          for c in chans]
    flow = _flow("iid", n, h, w, gen).to(dtype)
    for need_im in (True, False):
        _check_warp_bwd(ims, flow, gs, need_im)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", [(37, 61), (96, 100)])
def test_warp_bwd_planes_stay_apart(gen, dtype, h, w):
    """N = 3 planes under a converging, a beyond-the-border and a zero
    flow: taps never cross planes, each plane's d flow is the bits of that
    plane alone, and d im agrees with the plain version."""
    flow = torch.cat([_flow(k, 1, h, w, gen) for k in
                      ("converge", "beyond", "zero")]).to(
                          dtype=dtype, memory_format=CL)
    ims = [_randn((3, c, h, w), gen, dtype) for c in (3, 64)]
    gs = [_randn((3, c, h, w), gen, dtype) for c in (3, 64)]
    dflow, _ = _check_warp_bwd(ims, flow, gs)
    for i in range(3):
        def row(t):
            return t[i:i + 1].contiguous(memory_format=CL)
        alone = tw.warp_backward_cuda([row(t) for t in ims], row(flow),
                                      [row(t) for t in gs])
        assert torch.equal(alone[0], row(dflow)), i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("n,c,h,w,size", [
    (4, 2, 16, 16, (32, 32)),      # SpyNet's flow upsampling
    (4, 2, 64, 64, (32, 32)),      # the DMC's 0.5x resize
    (2, 3, 100, 140, (224, 224)),  # the perceptual loss's resize
    (2, 3, 256, 256, (224, 224)),
    (1, 64, 37, 61, (18, 30)),
    (2, 3, 20, 30, (224, 224)),
])
def test_resize_bwd_kernel_matches_plain_and_repeats(gen, dtype, n, c, h, w,
                                                     size):
    g = _randn((n, c) + size, gen, dtype)
    got = rs.resize_backward_cuda(g, h, w)
    assert got.dtype == dtype and got.shape == (n, c, h, w)
    assert torch.equal(got, rs.resize_backward_cuda(g, h, w))
    want = rs.resize_backward_plain(g, h, w)
    err = float((got.double() - want.double()).abs().max())
    tol = (1e-12 * float(want.abs().max()) if dtype == torch.float64
           else _tol(want, dtype, 1e-5))
    assert err <= tol, err
    # the autograd path launches E' and gives its bits
    x = torch.zeros((n, c, h, w), device="cuda", dtype=dtype,
                    requires_grad=True)
    cuda_build.reset_launches()
    rs.bilinear_resize(x, size).backward(g)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["resize_bwd"] == 1
    assert torch.equal(x.grad, got)


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


def _small_cascade():
    """A seeded damped DMC (16/16/24, 2 anchors), a 64x64 sequence of 2
    rows and its noise, and the cascade stage (p_frames 2)."""
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
    return model, seq, noises, stage


@pytest.mark.cuda
@pytest.mark.parametrize("mp", [False, True])
def test_cascade_step_repeats_bit_for_bit(gen, mp):
    """Two cascade steps from one state on the card, the same noise, f32
    and bf16 compute (--mp): every parameter and Adam moment equal bit for
    bit, without torch.use_deterministic_algorithms."""
    model, seq, noises, stage = _small_cascade()
    model = model.to("cuda")
    outs = []
    for _ in range(2):
        m = copy.deepcopy(model)
        opt = make_stage_optimizer(m, "all", 1e-4)
        step = tts.make_cascade_step(
            m, opt, stage, lambdas=[85.0, 170.0], dist_lambda=1.0,
            pl_lambda=0.0, compute_dtype=torch.bfloat16 if mp else None)
        xs = seq[1:].cuda()
        step(xs, xs, make_dpb(seq[0].cuda(), 16, 24),
             [tuple(t.cuda() for t in n) for n in noises])
        torch.cuda.synchronize()
        outs.append(({k: p.detach().clone() for k, p in
                      m.named_parameters()},
                     {k: v.clone() for k, v in opt.mu.items()}))
    assert not torch.are_deterministic_algorithms_enabled()
    for a, b in zip(outs[0], outs[1]):
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        assert not differ, differ


@pytest.mark.cuda
def test_cascade_step_card_against_cpu(gen):
    """One cascade step (p_frames 2, remat) of a seeded DMC at 64x64, the
    same noise, on the CPU (plain versions) and on the card (kernels)."""
    model, seq, noises, stage = _small_cascade()
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
              "space_to_depth", "resize_bwd"):
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
