"""PyTorch port, codec: one GOP (1 I-frame + 4 P-frames, 64x64, full
widths) through the JAX engine and the port's engine, on the port's seeded
damped init (`utils/weights.make_intra` / `make_dmc`, every weight x 0.5)
carried into the JAX trees (`flax_params_like`: eval_shape templates, no
eager flax init).

The streams must be byte-identical, each stack must decode the other's
streams, and the .bin container bytes must match. Within one stack the
decoder reproduces the encoder's DPB bit for bit (the encoder runs the
decoder's own stage functions); since the streams are equal, the port's
decode of the JAX streams equals the port's encoder recon exactly and vice
versa. Across stacks the recons agree to f32 noise (atol 1e-4).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_warp_twopass import (flax_params_like,  # noqa: F401
                                           one_torch_thread)
from tests.torch_port_util import moving_frames
from vcm_ts_tpu.codec import bitstream as jbs
from vcm_ts_tpu.codec.engine import IntraCodec as JIntraCodec
from vcm_ts_tpu.codec.engine import VideoCodec as JVideoCodec
from vcm_ts_tpu.models.dmc import DMC as JDMC
from vcm_ts_tpu.models.dmc import make_dpb as j_make_dpb
from vcm_ts_tpu.models.intra import IntraNoAR as JIntraNoAR
from vcm_ts_tpu_torch.codec import bitstream as tbs
from vcm_ts_tpu_torch.codec.engine import IntraCodec, VideoCodec, _i16
from vcm_ts_tpu_torch.models.dmc import make_dpb
from vcm_ts_tpu_torch.utils.weights import make_dmc, make_intra

# fine quantization, so the symbol planes are far from all-zero (about
# 4.5 bpp per P-frame on these frames) and the byte comparison has teeth
IQ, PQ = 0.1, 0.1
H = W = 64


def _encode(icodec, vcodec, frames, make, to_dev):
    """I-frame + chained P-frames: streams and the encoder's recons."""
    i_stream = icodec.compress(to_dev(frames[0]), IQ)
    r0 = icodec.decompress(i_stream, H, W, IQ)
    dpb = make(r0)
    p_streams, recons = [], [np.asarray(r0)]
    for t, x in enumerate(frames[1:]):
        out = vcodec.compress(to_dev(x), dpb, PQ, PQ, is_first_p=t == 0)
        dpb = out["dpb"]
        p_streams.append(out["bit_stream"])
        recons.append(np.asarray(dpb["ref_frame"]))
    return i_stream, p_streams, recons


def _decode(icodec, vcodec, i_stream, p_streams, make):
    r0 = icodec.decompress(i_stream, H, W, IQ)
    outs, _ = vcodec.decode_gop(make(r0), p_streams, H, W, PQ, PQ)
    return [np.asarray(r0)] + [np.asarray(o) for o in outs]


@pytest.fixture(scope="module")
def gop():
    ji = JIntraNoAR()
    jd = JDMC(anchor_num=4)
    x0 = jnp.zeros((1, H, W, 3))
    t_ic = IntraCodec(make_intra("cpu"), device="cpu")
    t_vc = VideoCodec(make_dmc("cpu"), device="cpu")
    ip = flax_params_like(lambda: ji.init(jax.random.PRNGKey(0), x0, 1.0),
                          t_ic.model)
    dp = flax_params_like(
        lambda: jd.init(jax.random.PRNGKey(1), x0, j_make_dpb(x0), 1.0, 1.0,
                        method="init_all"), t_vc.model)
    j_ic, j_vc = JIntraCodec(ji, ip), JVideoCodec(jd, dp)
    for c in (j_ic, j_vc, t_ic, t_vc):
        c.update()
    frames = moving_frames(2, 5)
    # XLA compiles and runs the JAX engine outside the interpreter lock, so
    # its GOP overlaps the port's
    with ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(_encode, j_ic, j_vc, frames, j_make_dpb,
                              jnp.asarray)
        tenc = _encode(t_ic, t_vc, frames, make_dpb, torch.from_numpy)
        jenc = jax_run.result()
    return {"frames": frames, "jax": (j_ic, j_vc), "port": (t_ic, t_vc),
            "jenc": jenc, "tenc": tenc}


def _same_table(a, b, name):
    for f in ("cdf", "sizes", "offsets"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"{name}.{f}")


def test_cdf_tables_byte_equal(gop):
    (j_ic, j_vc), (t_ic, t_vc) = gop["jax"], gop["port"]
    _same_table(t_vc.z_table, j_vc.z_table, "dmc z")
    _same_table(t_vc.z_mv_table, j_vc.z_mv_table, "dmc z_mv")
    _same_table(t_vc.y_table, j_vc.y_table, "laplace")
    _same_table(t_ic.z_table, j_ic.z_table, "intra z")
    _same_table(t_ic.y_table, j_ic.y_table, "gaussian")


def test_streams_byte_identical(gop):
    (ji, jp, _), (ti, tp, _) = gop["jenc"], gop["tenc"]
    assert ti == ji, "I-frame stream differs"
    assert len(tp) == len(jp) == 4
    assert min(len(s) for s in tp) > 1000, "streams too short to compare"
    for t, (a, b) in enumerate(zip(tp, jp)):
        assert a == b, f"P-frame {t} stream differs"


def test_encode_gop_matches_per_frame_compress(gop):
    t_ic, t_vc = gop["port"]
    _, p_streams, recons = gop["tenc"]
    frames = [torch.from_numpy(f) for f in gop["frames"][1:]]
    dpb0 = make_dpb(torch.from_numpy(recons[0]))
    streams, dpb = t_vc.encode_gop(frames, dpb0, PQ, PQ)
    assert streams == p_streams
    np.testing.assert_array_equal(dpb["ref_frame"].numpy(), recons[-1])


def test_port_decodes_both_stacks_streams(gop):
    t_ic, t_vc = gop["port"]
    ti, tp, trec = gop["tenc"]
    ji, jp, jrec = gop["jenc"]
    for name, (i_s, p_s) in (("port", (ti, tp)), ("jax", (ji, jp))):
        dec = _decode(t_ic, t_vc, i_s, p_s, make_dpb)
        for t, (d, e, je) in enumerate(zip(dec, trec, jrec)):
            np.testing.assert_array_equal(
                d, e, err_msg=f"{name} streams, frame {t}: port decode != "
                              "port encoder recon")
            np.testing.assert_allclose(d, je, rtol=0, atol=1e-4,
                                       err_msg=f"{name} streams, frame {t}")


def test_jax_decodes_both_stacks_streams(gop):
    j_ic, j_vc = gop["jax"]
    ti, tp, _ = gop["tenc"]
    ji, jp, jrec = gop["jenc"]
    for name, (i_s, p_s) in (("port", (ti, tp)), ("jax", (ji, jp))):
        dec = _decode(j_ic, j_vc, i_s, p_s, j_make_dpb)
        for t, (d, e) in enumerate(zip(dec, jrec)):
            np.testing.assert_array_equal(
                d, e, err_msg=f"{name} streams, frame {t}: JAX decode != "
                              "JAX encoder recon")


def test_bin_container_round_trip(gop, tmp_path):
    """encode_decode through .bin files: the port's container bytes equal
    the JAX package's, and each side reads the other's files."""
    t_ic, t_vc = gop["port"]
    ti, tp, trec = gop["tenc"]
    tbs.encode_i(H, W, 50, ti, tmp_path / "t_i.bin")
    jbs.encode_i(H, W, 50, ti, tmp_path / "j_i.bin")
    tbs.encode_p(tp[0], 70, 70, tmp_path / "t_p.bin")
    jbs.encode_p(tp[0], 70, 70, tmp_path / "j_p.bin")
    for k in ("i", "p"):
        assert ((tmp_path / f"t_{k}.bin").read_bytes()
                == (tmp_path / f"j_{k}.bin").read_bytes())
    assert tbs.decode_i(tmp_path / "j_i.bin") == (H, W, 50, ti)
    assert jbs.decode_p(tmp_path / "t_p.bin") == (70, 70, tp[0])

    x0 = torch.from_numpy(gop["frames"][0])
    out = t_ic.encode_decode(x0, IQ, tmp_path / "i.bin", W, H)
    assert out["bit"] == 8 * (14 + len(ti))
    np.testing.assert_array_equal(out["x_hat"].numpy(), trec[0])
    dpb = make_dpb(out["x_hat"])
    out = t_vc.encode_decode(torch.from_numpy(gop["frames"][1]), dpb,
                             tmp_path / "p.bin", W, H, PQ, PQ, True)
    assert out["bit"] == 8 * (8 + len(tp[0]))
    np.testing.assert_array_equal(out["dpb"]["ref_frame"].numpy(), trec[1])


def test_i16_saturation_well_defined():
    x = torch.tensor([0.0, 1.9, -1.9, 40000.0, -40000.0,
                      float("inf"), float("-inf"), float("nan")])
    np.testing.assert_array_equal(
        _i16(x).numpy(),
        np.asarray([0, 1, -1, 32767, -32768, 32767, -32768, 0], np.int16))
    np.testing.assert_array_equal(_i16(x.to(torch.bfloat16)).numpy()[3:],
                                  _i16(x).numpy()[3:])
