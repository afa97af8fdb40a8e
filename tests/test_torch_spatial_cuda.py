"""Spatial mode on the card: kernels A and D with a row window, and the
engines split by rows over two gloo ranks sharing the card.

Needs a CUDA device and nvcc, so every test carries the `cuda` marker and
skips without a card. Imports no JAX (run on the card with --noconftest):

    python -m pytest tests/test_torch_spatial_cuda.py -q -m cuda --noconftest

- Windowed launches of A (one tensor, the packed frame + feature, narrow
  and wide) and D, f32 and bf16, N = 2, odd H and W, windows at the edges
  and inside: bit for bit the rows of the whole launch, and of the
  windowed plain versions (the kernels' tolerance, 0).
- Two gloo ranks share cuda:0 (NCCL takes one rank per device): the
  engines' spatial mode codes an I-frame and a P-frame at 128x128
  (IntraNoAR N=32, DMC 16/16/24 on the seeded damped inits), and the
  streams equal the unsharded engines' on the card; each rank decodes its
  P-frame to the encoder's recon bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# pytest puts tests/ on sys.path (no __init__.py); the card machine may
# have another top-level package named "tests"
from torch_parallel_ranks import spatial_codec_case
from vcm_ts_tpu_torch.models.dmc import DMC
from vcm_ts_tpu_torch.models.intra import IntraNoAR
from vcm_ts_tpu_torch.ops import cuda_build
from vcm_ts_tpu_torch.ops import warp as tw
from vcm_ts_tpu_torch.ops import warp_twopass as td
from vcm_ts_tpu_torch.parallel.spawn import run_ranks
from vcm_ts_tpu_torch.utils.device import set_codec_numerics
from vcm_ts_tpu_torch.utils.weights import init_params

CL = torch.channels_last
N, H, W = 2, 37, 61
WINDOWS = [(0, 9), (28, 9), (11, 5), (0, 37)]  # (row0, rows)


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cuda_build.build_all()  # once, before any rank starts
    set_codec_numerics()
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(shape, g, dtype=torch.float32):
    return torch.randn(shape, device="cuda", generator=g).to(
        dtype=dtype, memory_format=CL)


def _rows(t, r0, hl):
    return t[:, :, r0:r0 + hl].contiguous(memory_format=CL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chans", [(3,), (64,), (3, 64)])
def test_windowed_warp_launch_is_rows_of_the_whole_launch(gen, chans, dtype):
    ims = [_randn((N, c, H, W), gen, dtype) for c in chans]
    flow = (_randn((N, 2, H, W), gen) * 9).to(dtype)
    whole = tw.warp_cuda(ims, flow)
    for r0, hl in WINDOWS:
        f = _rows(flow, r0, hl)
        before = cuda_build.LAUNCHES["warp"]
        got = tw.warp_cuda(ims, f, row0=r0)
        assert cuda_build.LAUNCHES["warp"] == before + 1
        for a, b, p in zip(got, whole, tw.warp_plain(ims, f, row0=r0)):
            torch.testing.assert_close(a, b[:, :, r0:r0 + hl], rtol=0,
                                       atol=0)
            torch.testing.assert_close(a, p, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,d", [(3, 16), (64, 6)])
def test_windowed_warp_twopass_launch_is_rows_of_the_whole_launch(gen, c, d,
                                                                 dtype):
    im = _randn((N, c, H, W), gen, dtype)
    flow = _randn((N, 2, H, W), gen) * (2 * d)  # |flow| past the bound
    whole = td.warp_twopass_cuda(im, flow, d)
    for r0, hl in WINDOWS:
        f = _rows(flow, r0, hl)
        before = cuda_build.LAUNCHES["warp_twopass"]
        got = td.warp_twopass_cuda(im, f, d, row0=r0)
        assert cuda_build.LAUNCHES["warp_twopass"] == before + 1
        torch.testing.assert_close(got, whole[:, :, r0:r0 + hl], rtol=0,
                                   atol=0)
        torch.testing.assert_close(
            got, td.warp_twopass_plain(im, f, d, row0=r0), rtol=0, atol=0)


@pytest.mark.cuda
def test_window_outside_the_image_raises(gen):
    im = _randn((1, 8, 16, 8), gen)
    with pytest.raises(ValueError):
        tw.warp_cuda([im], _randn((1, 2, 6, 8), gen), row0=12)
    with pytest.raises(ValueError):
        td.warp_twopass_cuda(im, _randn((1, 2, 6, 8), gen), 4, row0=-1)


@pytest.mark.cuda
def test_two_ranks_sharing_the_card_code_the_unsharded_streams(gen):
    intra = init_params(IntraNoAR(N=32, anchor_num=4, device="cpu"), seed=0,
                        kernel_scale=0.5)
    dmc = init_params(DMC(anchor_num=4, channel_mv=16, channel_N=16,
                          channel_M=24, device="cpu"), seed=1,
                      kernel_scale=0.5)
    rng = np.random.default_rng(3)
    frames = [np.kron(rng.random((1, 16, 16, 3)), np.ones((1, 8, 8, 1)))
              .astype(np.float32) for _ in range(2)]
    spec = dict(intra={"N": 32, "anchors": 4, "state": intra.state_dict()},
                dmc={"channels": (16, 16, 24), "anchors": 4,
                     "state": dmc.state_dict()},
                frames=frames, h=128, w=128, iq=0.1, pq=0.1, p_frames=1,
                device="cuda")
    plain = spatial_codec_case(spec)
    for rank in run_ranks(spatial_codec_case, 2, spec, backend="gloo",
                          device="cuda", timeout=600):
        r = rank["result"]
        assert r["i_stream"] == plain["i_stream"]
        assert r["p_enc"][0]["stream"] == plain["p_enc"][0]["stream"]
        np.testing.assert_array_equal(r["p_dec"][0], r["p_enc"][0]["recon"])
        for k in ("warp", "subpel_conv1x1", "pixel_shuffle_relayout"):
            assert rank["launches"][k] > 0, k
