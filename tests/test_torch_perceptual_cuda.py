"""The perceptual losses, a train step with one, and the Faster-RCNN eval
detector on the card against the same code on the CPU.

Needs a CUDA device and nvcc, so every test carries the `cuda` marker and
skips without a card. Imports no JAX (run on the card with --noconftest):

    python -m pytest tests/test_torch_perceptual_cuda.py -q -m cuda \
        --noconftest

Tolerances (TF32 off): a loss's value rtol 1e-4; its gradient to the
decoded frame in float64 on both devices within 1e-3 of the largest, and
the card's f32 gradient within 2e-2 of its float64 one in the 2-norm (in
f32 a ReLU or max-pool input within rounding of a kink takes the other
branch now and then, which moves a few pixels' gradient by up to a few
per cent of the largest: tests/test_torch_perceptual.py); the cascade
step as chip_smoke.py's 64x64 step (FrameAux rtol 1e-3, gradients within
2e-2 of each leaf's largest); the detector's FPN levels, RPN outputs and
box-head outputs within 1e-3 of each output's largest magnitude.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from vcm_ts_tpu_torch.eval import rcnn_native as rn
from vcm_ts_tpu_torch.models.dmc import DMC, make_dpb
from vcm_ts_tpu_torch.ops import cuda_build
from vcm_ts_tpu_torch.train import losses as L
from vcm_ts_tpu_torch.train import train_step as ts
from vcm_ts_tpu_torch.train.optimizer import make_stage_optimizer
from vcm_ts_tpu_torch.train.stages import StageParams
from vcm_ts_tpu_torch.utils.config import default_training_cfg
from vcm_ts_tpu_torch.utils.device import set_codec_numerics
from vcm_ts_tpu_torch.utils.weights import init_params

CH = (16, 16, 24)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cuda_build.build_all()
    set_codec_numerics()
    return torch.device("cuda")


def _frames(n, h, w, seed=0):
    """(decoded, target) NHWC f32: smooth seeded frames (no constant
    areas, whose max-pool ties the devices would break differently) and a
    noisy copy with values at and past the clip's bounds."""
    g = torch.Generator().manual_seed(seed)
    target = torch.nn.functional.interpolate(
        torch.rand((n, 3, h // 16, w // 16), generator=g), size=(h, w),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    decoded = target + 0.05 * torch.randn(target.shape, generator=g)
    decoded[:, ::7, ::5] = 0.0
    return decoded.contiguous(), target.contiguous()


def _pl_call(kind, model, target, decoded, layers):
    """pl_fn's call on a given copy of its network (f32 or float64)."""
    t = target.permute(0, 3, 1, 2).contiguous()
    d = decoded.permute(0, 3, 1, 2).contiguous()
    if kind == "yolo":
        return model(t, d, feature_layers=layers)
    return model(d, t, feature_layers=layers)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["resnet", "fpn", "yolo"])
def test_loss_on_card_matches_cpu(card, kind):
    cfg = default_training_cfg()
    cfg.SOLVER.PL_MODEL = kind
    layers = tuple(cfg.SOLVER.PL_LAYERS)
    decoded, target = _frames(2, 96, 112)
    grads, vals = {}, {}
    for dev in ("cpu", "cuda"):
        pl = L.get_perceptual_loss(cfg, dev, seed=0)
        for dt in (torch.float32, torch.float64):
            model = pl.model if dt == torch.float32 else copy.deepcopy(
                pl.model).double()
            d = decoded.to(dev, dt).detach().clone().requires_grad_()
            v = _pl_call(kind, model, target.to(dev, dt), d, layers)
            v.sum().backward()
            vals[dev, dt] = v.detach().cpu()
            grads[dev, dt] = d.grad.cpu()
    f32, f64 = torch.float32, torch.float64
    torch.testing.assert_close(vals["cuda", f32], vals["cpu", f32],
                               rtol=1e-4, atol=0)
    want = grads["cpu", f64]
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(grads["cuda", f64], want, rtol=0,
                               atol=1e-3 * float(want.abs().max()))
    g32, g64 = grads["cuda", f32].double(), grads["cuda", f64]
    assert float((g32 - g64).norm() / g64.norm()) <= 2e-2


@pytest.mark.cuda
def test_perceptual_cascade_step_on_card_matches_cpu(card):
    """A cascade step (p_frames 2, remat, 2 anchors, 64x64 smooth moving
    frames) of a narrow DMC with the ResNet loss: the card against the
    CPU."""
    cfg = default_training_cfg()
    stage = StageParams(stage=0, p_frames=2, trainable_mode="all",
                        forward_method="cascade", loss_dist_key="mse",
                        loss_rate_keys=("bpp_y", "bpp_z", "bpp_mv_y",
                                        "bpp_mv_z"), lr=1e-4,
                        perceptual_loss=True)
    model = init_params(DMC(anchor_num=2, channel_mv=CH[0], channel_N=CH[1],
                            channel_M=CH[2], device="cpu"), seed=0,
                        kernel_scale=0.5)
    # smooth frames: a frame of constant blocks makes constant areas in
    # the loss's 224x224 resize, whose ties in ResNet-50's max pool the
    # card and the CPU break differently (both valid subgradients)
    base = torch.nn.functional.interpolate(
        torch.rand((2, 3, 4, 4), generator=torch.Generator().manual_seed(1)),
        size=(64, 64), mode="bilinear", align_corners=False)
    seq = torch.stack([torch.roll(base, 4 * t, dims=3).permute(0, 2, 3, 1)
                       for t in range(3)]).contiguous()
    noises = ts.draw_cascade_noise(model, seq[1:],
                                   torch.Generator().manual_seed(2))
    out = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        opt = make_stage_optimizer(m, "all", 1e-4)
        step = ts.make_cascade_step(
            m, opt, stage, lambdas=[85.0, 170.0], dist_lambda=1.0,
            pl_lambda=float(cfg.SOLVER.PL_LAMBDA),
            pl_fn=L.get_perceptual_loss(cfg, dev, seed=0))
        xs = seq[1:].to(dev)
        aux, _ = step(xs, xs, make_dpb(seq[0].to(dev), CH[1], CH[2]),
                      [tuple(t.to(dev) for t in n) for n in noises])
        out[dev] = (aux, {k: v.cpu() for k, v in opt.mu.items()})
    assert float(out["cuda"][0].p_dist.min()) > 0
    for f in ts.FrameAux._fields:
        torch.testing.assert_close(getattr(out["cuda"][0], f).cpu(),
                                   getattr(out["cpu"][0], f), rtol=1e-3,
                                   atol=1e-6, msg=f)
    for k, want in out["cpu"][1].items():
        scale = max(float(want.abs().max()), 1e-30)
        torch.testing.assert_close(out["cuda"][1][k], want, rtol=0,
                                   atol=2e-2 * scale, msg=k)


@pytest.mark.cuda
def test_rcnn_detect_on_card_at_1088x1920(card, tmp_path):
    """The detector on seeded v2-layout weights (91 classes) through
    build_eval_adapter: a 1088x1920 frame; the networks on the card
    against the CPU on the same preprocessed input and crops; detect()
    on the card makes two pulls and gives boxes in the frame."""
    det = L.seeded_init(rn.FasterRCNNNativeDetector(device="cpu"), 0)
    with torch.no_grad():
        # as chip_smoke.py: LeCun-normal class logits (std about 0.12)
        # would leave every score under the 0.05 threshold
        det.roi_heads.box_predictor.cls_score.weight.mul_(8.0)
    path = str(tmp_path / "rcnn.pth")
    torch.save(det.state_dict(), path)
    adapter = rn.build_eval_adapter(path, device="cuda")
    gdet = adapter.detector
    frame = (np.random.default_rng(3).random((1088, 1920, 3)) * 255).astype(
        np.uint8)
    x, _ = gdet._preprocess(frame)
    levels, rpn = gdet.forward_backbone(x)
    cdet = rn.FasterRCNNNativeDetector.load_pth(path, device="cpu",
                                                min_size=1088,
                                                max_size=1920)
    clevels, crpn = cdet.forward_backbone(x.cpu())

    def close(a, b, name):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-3 * float(b.abs().max()),
                                   msg=name)

    for k, (a, b) in enumerate(zip(levels, clevels)):
        close(a, b, f"level {k}")
    for k, ((a, b), (c, d)) in enumerate(zip(rpn, crpn)):
        close(a, c, f"rpn logits {k}")
        close(b, d, f"rpn deltas {k}")
    crops = torch.randn((64, 256, 7, 7),
                        generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        gs, gd = gdet.roi_heads.box_predictor(
            gdet.roi_heads.box_head(crops.cuda()))
        cs, cd = cdet.roi_heads.box_predictor(cdet.roi_heads.box_head(crops))
    close(gs, cs, "box scores")
    close(gd, cd, "box deltas")

    pulls = gdet.pulls
    out = adapter(torch.from_numpy(frame[None].astype(np.float32) / 255.0)
                  .cuda())
    assert gdet.pulls - pulls == 2
    assert 0 < len(out["labels"]) <= 100
    assert out["labels"].min() >= 1 and out["labels"].max() < 91
    assert np.isfinite(out["boxes"]).all()
    assert (out["boxes"][:, [0, 2]] <= 1920).all()
    assert (out["boxes"][:, [1, 3]] <= 1088).all()
