"""PyTorch port, entropy layer against the JAX package: the quantized CDF
tables (part of the stream format) byte-equal, the scale-index derivation
equal, the rANS coder's bytes equal, and the factorized prior's CDF within
f32 noise."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import load_flax
from vcm_ts_tpu.entropy import bit_estimator as jbe
from vcm_ts_tpu.entropy.coder import EntropyCoder as JEntropyCoder
from vcm_ts_tpu.entropy.gaussian import GaussianCoder as JGaussianCoder
from vcm_ts_tpu_torch.entropy import bit_estimator as tbe
from vcm_ts_tpu_torch.entropy.coder import EntropyCoder
from vcm_ts_tpu_torch.entropy.gaussian import GaussianCoder
from vcm_ts_tpu_torch.entropy.rans import native_available


def _spread_params(c, seed):
    """BitEstimator params far from the init, so windows differ per channel."""
    rng = np.random.default_rng(seed)
    p = {}
    for name in ("f1", "f2", "f3", "f4"):
        p[name] = {k: rng.normal(0, 1.0, (1, 1, 1, c)).astype(np.float32)
                   for k in (("h", "b") if name == "f4" else ("h", "b", "a"))}
    return {"params": p}


def _same_table(a, b):
    for f in ("cdf", "sizes", "offsets"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("seed", [0, 1])
def test_bit_estimator_tables_byte_equal(seed):
    c = 24
    params = _spread_params(c, seed)
    want = jbe.build_table(jbe.BitEstimator(c), params)
    got = tbe.build_table(load_flax(tbe.BitEstimator(c), params))
    _same_table(got, want)


def test_bit_estimator_cdf_matches_jax():
    c = 16
    params = _spread_params(c, 3)
    x = np.random.default_rng(4).normal(0, 5, (2, 3, 5, c)).astype(np.float32)
    want = np.asarray(jbe.BitEstimator(c).apply(params, jnp.asarray(x)))
    port = load_flax(tbe.BitEstimator(c), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dist", ["laplace", "gaussian"])
def test_gaussian_tables_and_indexes_equal(dist):
    jg, tg = JGaussianCoder(dist), GaussianCoder(dist)
    _same_table(tg.build_table(), jg.build_table())
    _same_table(tg.build_table(search_range=40),
                jg.build_table(search_range=40))  # analytic rebuild
    rng = np.random.default_rng(5)
    s = np.exp(rng.uniform(np.log(1e-7), np.log(1e3), 20000))
    s = np.concatenate([s, [0.0, -1.0, 1e-5, 1e9]]).astype(np.float32)
    want = np.asarray(jg.build_indexes(jnp.asarray(s)))
    got = tg.build_indexes(torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, want)
    # Exact table rows and their f32 neighbours sit on the truncation
    # boundaries. XLA's and torch's f32 log differ by one ulp on ~3% of
    # inputs (measured), which there can move the index by one row, and
    # by no more.
    rows = jg.scale_table.astype(np.float32)
    s = np.concatenate([rows, np.nextafter(rows, 0),
                        np.nextafter(rows, 1e9)]).astype(np.float32)
    want = np.asarray(jg.build_indexes(jnp.asarray(s)))
    got = tg.build_indexes(torch.from_numpy(s)).numpy()
    assert np.abs(got - want).max() <= 1


def test_rans_bytes_equal_and_round_trip():
    assert native_available()
    table = GaussianCoder("laplace").build_table()
    rng = np.random.default_rng(6)
    n = 5000
    idx = rng.integers(0, table.n, n).astype(np.int32)
    sym = np.round(rng.laplace(0, 4, n)).astype(np.int32)
    sym[:10] = [300, -300, 5000, -5000, 31000, -31000, 0, 1, -1, 77]  # bypass
    streams = []
    for coder in (EntropyCoder(), JEntropyCoder()):
        coder.reset_encoder()
        coder.encode_with_indexes(sym, idx, table)
        streams.append(coder.flush_encoder())
    assert streams[0] == streams[1]
    dec = EntropyCoder()
    dec.set_stream(streams[1])
    np.testing.assert_array_equal(dec.decode_stream(idx, table), sym)
