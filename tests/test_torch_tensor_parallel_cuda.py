"""Tensor parallelism on the card: kernels B and C at the slices that a
model axis gives each rank, and the split forward on two gloo ranks that
share the card.

Needs a CUDA device and nvcc, so every test carries the `cuda` marker and
skips without a card. Imports no JAX (run on the card with --noconftest):

    python -m pytest tests/test_torch_tensor_parallel_cuda.py -q -m cuda \
        --noconftest

- Kernel B (subpel_conv1x1) at every (Cin, C / n) slice of the DMC's and
  IntraNoAR's 1x1 SubpelConv sites for n = 2 and 4 (C / n with r*r*C/n <=
  16 takes the narrow path), and kernel C (pixel_shuffle_relayout) at the
  3x3 sites' C / n, f32 and bf16, at 24x40 inputs, against their plain
  versions: B within chip_smoke.py's tolerances (f32 1e-4, bf16 2^-6 of
  the largest), C bit for bit.
- The damped DMC (16/16/24) and IntraNoAR (N=16) at 64x64 split over two
  gloo ranks sharing the card (tp_forward; NCCL takes one rank per device)
  against the unsharded forwards in one process on the card: bpp rtol
  1e-3 and the image within 1e-3 of its largest (chip_smoke.py phase 13's
  gate), both ranks' outputs bit-equal, the kernels launched.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# pytest puts tests/ on sys.path (no __init__.py); the card machine may
# have another top-level package named "tests"
from torch_parallel_ranks import tp_forward_case
from vcm_ts_tpu_torch.models.dmc import DMC
from vcm_ts_tpu_torch.models.intra import IntraNoAR
from vcm_ts_tpu_torch.ops import cuda_build
from vcm_ts_tpu_torch.ops import subpel as ts
from vcm_ts_tpu_torch.parallel.spawn import run_ranks
from vcm_ts_tpu_torch.utils.device import set_codec_numerics
from vcm_ts_tpu_torch.utils.weights import init_params

CL = torch.channels_last
# (Cin, C) of the 1x1 SubpelConv sites (chip_smoke.py's CONV1X1_SHAPES)
B_SITES = ((64, 32), (192, 16), (128, 64), (64, 64), (64, 2), (96, 96),
           (144, 144), (192, 192), (288, 288))
# C of the 3x3 sites (chip_smoke.py's RELAYOUT_SITES)
C_SITES = (64, 32)
DTYPES = (torch.float32, torch.bfloat16)


def _slices(c):
    return [c // n for n in (2, 4) if c % n == 0 and c >= n]


B_CASES = sorted({(cin, cs) for cin, c in B_SITES for cs in _slices(c)})
C_CASES = sorted({cs for c in C_SITES for cs in _slices(c)})


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cuda_build.build_all()  # once, before any rank starts
    set_codec_numerics()  # TF32 off: the plain versions' convs in f32
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("cin,c", B_CASES)
def test_kernel_b_at_tp_slices(card, cin, c, dtype):
    x = torch.randn((2, cin, 24, 40), device="cuda", generator=card).to(
        dtype=dtype, memory_format=CL)
    wk = (torch.randn((4, cin, c), device="cuda", generator=card)
          / cin ** 0.5).to(dtype)
    bk = (torch.randn((4, c), device="cuda", generator=card) * 0.1).to(dtype)
    got = ts.subpel_conv1x1_cuda(x, wk, bk, 2).float()
    want = ts.subpel_conv1x1_plain(x, wk, bk, 2).float()
    tol = (1e-4 if dtype == torch.float32
           else 2.0 ** -6 * max(1.0, float(want.abs().max())))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("c", C_CASES)
def test_kernel_c_at_tp_slices(card, c, dtype):
    x = torch.randn((2, 4 * c, 24, 40), device="cuda", generator=card).to(
        dtype=dtype, memory_format=CL)
    assert torch.equal(ts.relayout_cuda(x, 2), ts.relayout_plain(x, 2))


@pytest.mark.cuda
def test_tp_forward_on_two_gloo_ranks_matches_unsharded(card):
    dmc = init_params(DMC(anchor_num=2, channel_mv=16, channel_N=16,
                          channel_M=24, device="cpu"), seed=0,
                      kernel_scale=0.5)
    intra = init_params(IntraNoAR(N=16, anchor_num=2, device="cpu"), seed=0,
                        kernel_scale=0.5)
    rng = np.random.default_rng(0)
    base = rng.random((1, 8, 8, 3)).astype(np.float32)
    up = np.ones((1, 8, 8, 1), np.float32)
    spec = {"dmc": {"channels": (16, 16, 24), "anchors": 2,
                    "state": dmc.state_dict()},
            "intra": {"N": 16, "anchors": 2, "state": intra.state_dict()},
            "x": np.kron(base, up), "ref": np.kron(np.roll(base, 1, 2), up),
            "ix": np.kron(base, up), "device": "cuda"}
    want = tp_forward_case(spec)
    res = run_ranks(tp_forward_case, 2, spec, backend="gloo", device="cuda")
    for name, key in (("dmc", "ref_frame"), ("intra", "x_hat")):
        for r in res:
            got = r["result"][name]
            assert got["n_split"] > 0
            a, b = got[key], want[name][key]
            assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max(), name
            np.testing.assert_allclose(got["bpp"], want[name]["bpp"],
                                       rtol=1e-3)
        assert np.array_equal(res[0]["result"][name][key],
                              res[1]["result"][name][key])
    for k in ("warp", "subpel_conv1x1", "pixel_shuffle_relayout"):
        assert res[0]["launches"][k] > 0, k
