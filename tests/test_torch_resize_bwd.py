"""PyTorch port: the bilinear resize's backward (kernel E''s plain version)
against the JAX package.

`resize_backward_plain` (Ry^T . g . Rx, summed in float64) and the
autograd Function that `bilinear_up2`, `bilinear_down2` and the
perceptual loss's resize to 224 go through, on the CPU, held to:
- jax.vjp of vcm_ts_tpu/ops/resize.py's `bilinear_up2` and
  `bilinear_down2`, and of `jax.image.resize(..., "bilinear")` to 224x224;
- autograd through F.interpolate (align_corners=False) on the CPU.
Inputs are seeded numpy arrays handed to both stacks. Tolerance: 1e-4 of
the largest magnitude against JAX (both stacks compute a tap's source
coordinate in f32, torch as (o + 0.5) in/out - 0.5 and JAX as (o + 0.5)
/ (out/in) - 0.5: at a coordinate near 256 they part by a few 1e-5), 1e-5
against F.interpolate's own backward (the same coordinates; the sums run
in another order). The Function's backward is the plain version bit for
bit, and its forward is F.interpolate's.
The CUDA kernel is held to this plain version on the card
(tests/test_torch_train_cuda.py, chip_smoke.py phase 8).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_warp_twopass import one_torch_thread  # noqa: F401
from tests.torch_port_util import nchw, nhwc
from vcm_ts_tpu.ops import resize as j_resize
from vcm_ts_tpu_torch.ops import resize as t_resize

CASES = [  # (kind, N, H, W, C)
    ("up2", 2, 5, 7, 2),      # SpyNet's flow upsampling
    ("up2", 1, 16, 12, 3),
    ("down2", 2, 8, 10, 3),
    ("down2", 1, 13, 6, 2),   # odd height: the last row takes no tap
    ("224", 1, 32, 48, 3),    # upsampling to the perceptual loss's size
    ("224", 1, 256, 256, 3),  # the train step's crops
]


def _out_hw(kind, h, w):
    return {"up2": (2 * h, 2 * w), "down2": (h // 2, w // 2),
            "224": (224, 224)}[kind]


def _jax_fn(kind):
    if kind == "up2":
        return j_resize.bilinear_up2
    if kind == "down2":
        return j_resize.bilinear_down2
    return lambda x: jax.image.resize(x, (x.shape[0], 224, 224, x.shape[3]),
                                      method="bilinear", antialias=False)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("kind,n,h,w,c", CASES)
def test_resize_backward_plain_matches_jax_and_torch(kind, n, h, w, c):
    rng = np.random.default_rng([n, h, w, c])
    ho, wo = _out_hw(kind, h, w)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    g = rng.standard_normal((n, ho, wo, c)).astype(np.float32)
    _, vjp = jax.vjp(_jax_fn(kind), jnp.asarray(x))
    want_jax = np.asarray(vjp(jnp.asarray(g))[0])

    got = t_resize.resize_backward_plain(nchw(g), h, w)
    assert got.shape == (n, c, h, w) and got.dtype == torch.float32
    _close(nhwc(got), want_jax, 1e-4)

    xt = nchw(x).requires_grad_()
    F.interpolate(xt, size=(ho, wo), mode="bilinear", align_corners=False,
                  antialias=False).backward(nchw(g))
    _close(nhwc(got), nhwc(xt.grad), 1e-5)

    # the autograd Function's CPU path: F.interpolate forward, the plain
    # backward bit for bit, the input's memory format kept
    for fmt in (torch.contiguous_format, torch.channels_last):
        xf = nchw(x).contiguous(memory_format=fmt).requires_grad_()
        fn = {"up2": t_resize.bilinear_up2,
              "down2": t_resize.bilinear_down2}.get(
                  kind, lambda t: t_resize.bilinear_resize(t, (224, 224)))
        y = fn(xf)
        with torch.no_grad():
            assert torch.equal(y, F.interpolate(
                xf, size=(ho, wo), mode="bilinear", align_corners=False))
        y.backward(nchw(g))
        assert torch.equal(xf.grad, got)
        assert xf.grad.is_contiguous(memory_format=fmt)


def test_resize_weights_are_jax_weight_matrices():
    """Each axis's matrix R (out = R . in) against the one jax.image.resize
    contracts with: its Jacobian."""
    for n_in, n_out in ((7, 14), (10, 5), (256, 224), (13, 6)):
        r = t_resize.resize_weights(n_in, n_out).numpy()

        def f(v, n_out=n_out):
            return jax.image.resize(v, (n_out,), method="bilinear",
                                    antialias=False)

        want = np.asarray(jax.jacfwd(f)(jnp.zeros((n_in,), jnp.float32)))
        np.testing.assert_allclose(r, want, rtol=0, atol=5e-5)
        assert np.array_equal(r != 0, np.abs(want) > 5e-5)


def test_bf16_plain_backward_rounds_a_float64_sum_once():
    rng = np.random.default_rng(3)
    g = nchw(rng.standard_normal((2, 10, 14, 2)).astype(np.float32))
    want = t_resize.resize_backward_plain(g, 5, 7)
    got = t_resize.resize_backward_plain(g.to(torch.bfloat16), 5, 7)
    assert got.dtype == torch.bfloat16
    ref = t_resize.resize_backward_plain(
        g.to(torch.bfloat16).double(), 5, 7).to(torch.bfloat16)
    assert torch.equal(got, ref)
    _close(got.float(), want, 2.0 ** -7)


def test_float64_plain_backward_matches_autograd():
    """float64 data (the perceptual losses' float64 gradient checks): the
    plain version computes its weights and sums in float64, as
    F.interpolate's float64 backward does (1e-12 of the largest)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 3, 40, 30))
                         ).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((1, 3, 224, 224)))
    F.interpolate(x, size=(224, 224), mode="bilinear", align_corners=False,
                  antialias=False).backward(g)
    got = t_resize.resize_backward_plain(g, 40, 30)
    assert got.dtype == torch.float64
    _close(got, x.grad, 1e-12)


def test_plain_backward_rows_equal_rows_alone():
    """A row's d x has the same bits in a batch of 8 as alone or in a
    batch of 4 (one product of fixed size per plane), as the CPU train
    steps need: ranks that split the global rows must see the rows' bits
    of one process."""
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.standard_normal((8, 2, 64, 64)).astype(
        np.float32))
    whole = t_resize.resize_backward_plain(g, 32, 32)
    halves = torch.cat([t_resize.resize_backward_plain(g[:4], 32, 32),
                        t_resize.resize_backward_plain(g[4:], 32, 32)])
    assert torch.equal(whole, halves)
    assert torch.equal(whole[5:6],
                       t_resize.resize_backward_plain(g[5:6], 32, 32))
