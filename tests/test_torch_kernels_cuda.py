"""Kernels A/B/C/D against their plain versions on CUDA tensors.

Needs a CUDA device and nvcc (the kernels have no CPU mode), so every test
here carries the `cuda` marker and skips without a card. Imports no JAX, so
it runs where the port runs (tests/conftest.py imports JAX, hence
--noconftest on a machine without it):

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda --noconftest
"""

from __future__ import annotations

import pytest
import torch

from vcm_ts_tpu_torch.ops import cuda_build
from vcm_ts_tpu_torch.ops import subpel as ts
from vcm_ts_tpu_torch.ops import warp as tw
from vcm_ts_tpu_torch.ops import warp_twopass as td

CL = torch.channels_last


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cuda_build.build_all()
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(shape, g, dtype=torch.float32):
    return torch.randn(shape, device="cuda", generator=g).to(
        dtype=dtype, memory_format=CL if len(shape) == 4 else
        torch.contiguous_format)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_kernel_bit_identical_to_plain(gen, dtype):
    im = _randn((2, 67, 40, 56), gen, dtype)
    flow = _randn((2, 2, 40, 56), gen) * 9
    parts = (im[:, :3].contiguous(memory_format=CL),
             im[:, 3:].contiguous(memory_format=CL))
    for a, b in zip(tw.warp_cuda(parts, flow), tw.warp_plain(parts, flow)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("flow_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chans", [(1,), (2,), (3,), (4,), (5,), (8,), (64,),
                                   (3, 64)])
def test_warp_kernel_widths_and_flow_dtypes(gen, chans, dtype, flow_dtype):
    """Narrow tensors (one lane per pixel), wide ones (a lane group per
    pixel), the packed frame + feature, and an f32 or bf16 flow read as it
    is: all bit-identical to the plain version, N = 2, odd H and W."""
    ims = [_randn((2, c, 37, 61), gen, dtype) for c in chans]
    flow = (_randn((2, 2, 37, 61), gen) * 9).to(flow_dtype)
    before = cuda_build.LAUNCHES["warp"]
    got = tw.warp_cuda(ims, flow)
    assert cuda_build.LAUNCHES["warp"] == before + 1
    for a, b in zip(got, tw.warp_plain(ims, flow)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [2, 3, 32, 64, 144])
def test_relayout_kernel_bit_identical_to_plain(gen, dtype, c):
    x = _randn((2, 4 * c, 9, 14), gen, dtype)
    torch.testing.assert_close(ts.relayout_cuda(x, 2),
                               ts.relayout_plain(x, 2), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,c", [(64, 64), (64, 2), (128, 64), (64, 32),
                                   (96, 96), (144, 144), (192, 192),
                                   (192, 16), (288, 288)])
def test_subpel_conv1x1_kernel_matches_plain(gen, cin, c):
    x = _randn((1, cin, 17, 30), gen)
    wk = _randn((4, cin, c), gen) / cin ** 0.5
    bk = _randn((4, c), gen)
    torch.testing.assert_close(ts.subpel_conv1x1_cuda(x, wk, bk, 2),
                               ts.subpel_conv1x1_plain(x, wk, bk, 2),
                               rtol=1e-5, atol=1e-4)


MAIN_PATH_CONV1X1 = [(64, 32), (128, 64), (64, 64), (64, 2), (96, 96),
                     (144, 144), (192, 192), (192, 16), (288, 288)]


def _conv1x1_operands(cin, c, n, h, w, g, dtype):
    x = _randn((n, cin, h, w), g, dtype)
    wk = (_randn((4, cin, c), g) / cin ** 0.5).to(dtype)
    bk = _randn((4, c), g).to(dtype)
    return x, wk, bk


def _conv1x1_tol(want, dtype):
    # f32: both sum in f32 in other orders; bf16: both round an f32 sum to
    # bf16, so they may land one or two bf16 ulps apart
    if dtype == torch.float32:
        return dict(rtol=1e-5, atol=1e-4)
    return dict(rtol=0, atol=2.0 ** -6 * float(want.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,c", MAIN_PATH_CONV1X1 + [(20, 5), (36, 3)])
@pytest.mark.parametrize("n,h,w", [(2, 17, 30), (2, 1, 7)])
def test_subpel_conv1x1_kernel_ragged_m(gen, dtype, cin, c, n, h, w):
    """Every main-path width (tensor cores in bf16, FMA tiles in f32, the
    narrow path at 64 -> 2), plus widths that take the element-wise copies
    (20 -> 5) and the narrow path's (36 -> 3), at pixel counts that fill no
    tile."""
    x, wk, bk = _conv1x1_operands(cin, c, n, h, w, gen, dtype)
    before = cuda_build.LAUNCHES["subpel_conv1x1"]
    got = ts.subpel_conv1x1_cuda(x, wk, bk, 2)
    assert cuda_build.LAUNCHES["subpel_conv1x1"] == before + 1
    want = ts.subpel_conv1x1_plain(x, wk, bk, 2)
    torch.testing.assert_close(got.float(), want.float(),
                               **_conv1x1_tol(want, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,c", [(64, 32), (128, 64), (64, 2), (144, 144)])
def test_subpel_conv1x1_kernel_bits_do_not_depend_on_m(gen, dtype, cin, c):
    """A band of rows of x gives the same bits as those rows inside the
    whole tensor: the sum order is fixed by (Cin, C, r, dtype) alone."""
    x, wk, bk = _conv1x1_operands(cin, c, 1, 34, 60, gen, dtype)
    whole = ts.subpel_conv1x1_cuda(x, wk, bk, 2)
    band = x[:, :, 5:23].contiguous(memory_format=CL)
    got = ts.subpel_conv1x1_cuda(band, wk, bk, 2)
    torch.testing.assert_close(got, whole[:, :, 10:46], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w,d", [(2, 64, 37, 61, 24), (1, 3, 40, 56, 16),
                                       (2, 20, 13, 128, 6)])
def test_warp_twopass_kernel_bit_identical_to_plain(gen, dtype, n, c, h, w,
                                                    d):
    im = _randn((n, c, h, w), gen, dtype)
    flow = _randn((n, 2, h, w), gen) * (2 * d)  # |flow| past the bound
    before = cuda_build.LAUNCHES["warp_twopass"]
    got = td.warp_twopass_cuda(im, flow, d)
    assert cuda_build.LAUNCHES["warp_twopass"] == before + 1
    torch.testing.assert_close(got, td.warp_twopass_plain(im, flow, d),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_wrappers_raise_on_strides_they_do_not_take(gen):
    x = _randn((1, 16, 8, 8), gen).contiguous()  # NCHW memory
    with pytest.raises(ValueError):
        ts.relayout_cuda(x, 2)
    with pytest.raises(ValueError):
        tw.warp_cuda([x], _randn((1, 2, 8, 8), gen))
    with pytest.raises(ValueError):
        td.warp_twopass_cuda(x, _randn((1, 2, 8, 8), gen), 4)
    with pytest.raises(ValueError):  # flow of another size
        td.warp_twopass_cuda(_randn((1, 16, 8, 8), gen),
                             _randn((1, 2, 8, 9), gen), 4)
