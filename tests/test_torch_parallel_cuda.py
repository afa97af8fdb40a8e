"""Data-parallel and FSDP training steps on the card (parallel/, the
train step's reduction and FSDP paths on CUDA tensors, with the
hand-written kernels).

Needs a CUDA device and nvcc, so every test carries the `cuda` marker and
skips without a card. Imports no JAX (run on the card with --noconftest):

    python -m pytest tests/test_torch_parallel_cuda.py -q -m cuda --noconftest

A DMC at 16/16/24 with 4 anchors on the seeded damped init, 64x64 frames.
One NCCL rank (NCCL takes one rank per device, and the card machine has
one) runs the DP and FSDP steps against the plain step on the same rows;
two gloo ranks share the card (gloo stages CUDA tensors through the host)
against one process on the 8 global rows. The card's steps are not
deterministic (A''s f32 atomics), so the tolerance is chip_smoke.py's
card-against-card one (phase 8): FrameAux rtol 1e-3, gradients (the first
moments) within 2e-2 of each leaf's largest magnitude, parameters within
1e-6 + 0.05 lr where the gradient is above 4e-2 of its leaf's largest,
2.1 lr elsewhere.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# pytest puts tests/ on sys.path (no __init__.py); the card machine may
# have another top-level package named "tests"
from torch_parallel_ranks import step_case, steps_case
from vcm_ts_tpu_torch.models.dmc import DMC
from vcm_ts_tpu_torch.ops import cuda_build
from vcm_ts_tpu_torch.parallel.spawn import run_ranks
from vcm_ts_tpu_torch.utils.device import set_codec_numerics
from vcm_ts_tpu_torch.utils.weights import init_params

CH = (16, 16, 24)
LR = 1e-4
STAGE = dict(stage=0, p_frames=1, trainable_mode="all",
             forward_method="single", loss_dist_key="mse",
             loss_rate_keys=("bpp_mv_y", "bpp_mv_z", "bpp_y", "bpp_z"),
             lr=LR, perceptual_loss=False)


@pytest.fixture(scope="module")
def spec():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cuda_build.build_all()  # once, before the ranks start
    set_codec_numerics()
    model = init_params(DMC(anchor_num=4, channel_mv=CH[0], channel_N=CH[1],
                            channel_M=CH[2], device="cpu"), seed=0,
                        kernel_scale=0.5)
    rng = np.random.default_rng(0)
    base = rng.random((2, 8, 8, 8, 3)).astype(np.float32)
    frames = np.kron(base, np.ones((1, 1, 8, 8, 1), np.float32))
    noise = [rng.uniform(-0.5, 0.5, s).astype(np.float32)
             for s in model.noise_shapes(8, 64, 64)]
    return dict(channels=CH, anchors=4, lambdas=[85.0, 170.0, 380.0, 840.0],
                lr=LR, clip=0.0, accum=1, kind="single", stage=STAGE,
                device="cuda", x=frames[1], ref=frames[0], noise=noise,
                state={k: v.clone() for k, v in model.state_dict().items()})


def _rows(spec, n):
    return dict(spec, x=spec["x"][:n], ref=spec["ref"][:n],
                noise=[v[:n] for v in spec["noise"]])


def _close(got, want):
    for f, b in want["aux"].items():
        np.testing.assert_allclose(got["aux"][f], b, rtol=1e-3, atol=1e-6,
                                   err_msg=f)
    for k, m in want["opt"]["mu"].items():
        scale = max(float(np.abs(m).max()), 1e-30)
        d = np.abs(got["opt"]["mu"][k] - m)
        assert d.max() <= 2e-2 * scale, (k, d.max() / scale)
        firm = np.abs(m) > 4e-2 * scale
        tol = np.where(firm, 1e-6 + 0.05 * LR, 2.1 * LR)
        dp = np.abs(got["params"][k] - want["params"][k])
        assert (dp <= tol).all(), (k, dp.max())


@pytest.mark.cuda
@pytest.mark.parametrize("fsdp", [False, True])
def test_one_nccl_rank_matches_plain_step(spec, fsdp):
    one = _rows(spec, 4)
    want = step_case(one)
    got = run_ranks(step_case, 1, dict(one, fsdp=fsdp), backend="nccl",
                    device="cuda")[0]
    _close(got["result"], want)
    assert got["result"]["counts"]["reduce_gradients"] == 1
    for k in ("warp", "warp_bwd", "subpel_conv1x1",
              "pixel_shuffle_relayout", "space_to_depth"):
        assert got["launches"][k] > 0, k


@pytest.mark.cuda
def test_two_gloo_ranks_sharing_the_card_match_one_process(spec):
    """DP on 2 gloo ranks (4 rows each) against the 8-row step."""
    want = step_case(spec)
    res = run_ranks(steps_case, 2, [spec], backend="gloo", device="cuda")
    for r in res:
        _close(r["result"][0], want)
