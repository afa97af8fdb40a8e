"""Serving on the card: batched compress/decompress, concurrent sessions and
the kernels' batch invariance, at small shapes.

Needs a CUDA device and nvcc, so every test here carries the `cuda` marker
and skips without a card. Imports no JAX (tests/conftest.py does, hence
--noconftest on a machine without it):

    python -m pytest tests/test_torch_serving_cuda.py -q -m cuda --noconftest

Comparisons are exact: a row of a batch codes to the bytes of that row
coded alone, a batch decodes to the encoder's DPB, two sessions on their
own streams give what one gives, and a kernel launched at N = 2 gives each
row the bits of its N = 1 launch.
"""

from __future__ import annotations

import pytest
import torch

from vcm_ts_tpu_torch.codec.engine import IntraCodec, VideoCodec, run_sessions
from vcm_ts_tpu_torch.models.dmc import make_dpb
from vcm_ts_tpu_torch.ops import cuda_build
from vcm_ts_tpu_torch.ops import subpel as ts
from vcm_ts_tpu_torch.ops import warp as tw
from vcm_ts_tpu_torch.ops import warp_twopass as td
from vcm_ts_tpu_torch.utils.precision import cast_params
from vcm_ts_tpu_torch.utils.weights import make_dmc, make_intra

CL = torch.channels_last
H, W = 128, 192
Q = torch.tensor([0.5, 0.3]).reshape(2, 1, 1, 1)


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cuda_build.build_all()
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.fixture(scope="module", params=["f32", "bf16_fast_warp"])
def codecs(request, gen):
    if request.param == "f32":
        mi, md = make_intra("cuda"), make_dmc("cuda")
    else:
        mi = cast_params(make_intra("cuda"), torch.bfloat16)
        md = cast_params(make_dmc("cuda", fast_warp=True), torch.bfloat16)
    ic, vc = IntraCodec(mi, device="cuda"), VideoCodec(md, device="cuda")
    ic.update()
    vc.update()
    xs = [torch.rand((2, H, W, 3), device="cuda", generator=gen)
          for _ in range(3)]
    return ic, vc, xs


def _row(t, i):
    return t[i:i + 1]


@pytest.mark.cuda
def test_batch_rows_code_and_decode_as_alone(codecs):
    ic, vc, xs = codecs
    i_b = ic.compress_batch(xs[0], Q)
    r0 = ic.decompress_batch(i_b, H, W, Q)
    out = vc.compress_batch(xs[1], make_dpb(r0), Q, Q, True)
    dec = vc.decompress_batch(make_dpb(r0), out["bit_streams"], H, W, Q, Q,
                              True)
    for k, v in out["dpb"].items():
        assert torch.equal(dec["dpb"][k], v), k
    for i in range(2):
        q = _row(Q, i)
        assert ic.compress(_row(xs[0], i), q) == i_b[i]
        r = ic.decompress(i_b[i], H, W, q)
        assert torch.equal(r, _row(r0, i))
        one = vc.compress(_row(xs[1], i), make_dpb(r), q, q, True)
        assert one["bit_stream"] == out["bit_streams"][i]
        for k, v in out["dpb"].items():
            assert torch.equal(one["dpb"][k], _row(v, i)), (i, k)


@pytest.mark.cuda
def test_two_sessions_on_their_streams_equal_one(codecs):
    ic, vc, xs = codecs
    r0 = ic.decompress(ic.compress(_row(xs[0], 0), 0.5), H, W, 0.5)
    dpb0 = make_dpb(r0)
    frames = [_row(x, 0) for x in xs[1:]]
    ref, _ = vc.encode_gop(frames, dpb0, 0.7, 0.7)
    ref_rec, _ = vc.decode_gop(dpb0, ref, H, W, 0.7, 0.7)
    _, encs = run_sessions(
        [lambda: vc.encode_gop(frames, dpb0, 0.7, 0.7)[0]] * 2, "cuda")
    _, decs = run_sessions(
        [lambda: vc.decode_gop(dpb0, ref, H, W, 0.7, 0.7)[0]] * 2, "cuda")
    for streams, recons in zip(encs, decs):
        assert streams == ref
        assert all(torch.equal(a, b) for a, b in zip(recons, ref_rec))


def _randn(shape, g, dtype):
    return torch.randn(shape, device="cuda", generator=g).to(
        dtype=dtype, memory_format=CL if len(shape) == 4 else
        torch.contiguous_format)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["warp", "warp_narrow", "subpel_conv1x1",
                                    "pixel_shuffle_relayout",
                                    "warp_twopass"])
def test_kernels_are_batch_invariant(gen, kernel, dtype):
    """Each row of an N = 2 launch equals the N = 1 launch on that row."""
    h, w = 37, 61
    flow = _randn((2, 2, h, w), gen, torch.float32) * 9
    if kernel == "warp":
        ims = [_randn((2, 3, h, w), gen, dtype), _randn((2, 64, h, w), gen,
                                                        dtype)]
        fn = lambda r: tw.warp_cuda([r(t) for t in ims], r(flow))  # noqa
    elif kernel == "warp_narrow":
        im = _randn((2, 3, h, w), gen, dtype)
        fn = lambda r: tw.warp_cuda([r(im)], r(flow))  # noqa: E731
    elif kernel == "subpel_conv1x1":
        x = _randn((2, 64, h, w), gen, dtype)
        wk = (_randn((4, 64, 32), gen, torch.float32) / 8).to(dtype)
        bk = _randn((4, 32), gen, torch.float32).to(dtype)
        fn = lambda r: [ts.subpel_conv1x1_cuda(r(x), wk, bk, 2)]  # noqa
    elif kernel == "pixel_shuffle_relayout":
        x = _randn((2, 256, h, w), gen, dtype)
        fn = lambda r: [ts.relayout_cuda(r(x), 2)]  # noqa: E731
    else:
        im = _randn((2, 64, h, w), gen, dtype)
        fn = lambda r: [td.warp_twopass_cuda(r(im), r(flow), 6)]  # noqa
    batched = fn(lambda t: t)
    for i in range(2):
        for a, b in zip(batched, fn(lambda t, i=i: _row(t, i))):
            torch.testing.assert_close(_row(a, i), b, rtol=0, atol=0)
