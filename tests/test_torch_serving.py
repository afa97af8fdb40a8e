"""PyTorch port, serving: batched compress/decompress in both engines, the
overlapped GOP loops and concurrent sessions through one codec, against
the JAX engine and against the port's own single-stream calls.

The models are the port's seeded damped init (`utils/weights.make_dmc`,
`make_intra`) at 64x64; the JAX engine holds the same weights
(`flax_params_like`). A batch is two sequences at two rate points (q =
0.1 and 0.2, so the planes are far from zero). Comparisons are exact:
streams byte for byte, recons, DPBs and decoded symbol planes bit for bit.
Within the port that needs each batch row to be computed as that row alone
(ops/rowwise.py: convs, dense layers and the SE means go row by row).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_warp_twopass import flax_params_like
from tests.test_torch_warp_twopass import one_torch_thread  # noqa: F401
from tests.torch_port_util import moving_frames
from vcm_ts_tpu.codec.engine import IntraCodec as JIntraCodec
from vcm_ts_tpu.codec.engine import VideoCodec as JVideoCodec
from vcm_ts_tpu.models.dmc import DMC as JDMC
from vcm_ts_tpu.models.dmc import make_dpb as j_make_dpb
from vcm_ts_tpu.models.intra import IntraNoAR as JIntraNoAR
from vcm_ts_tpu_torch.codec.engine import IntraCodec, VideoCodec, run_sessions
from vcm_ts_tpu_torch.models.dmc import make_dpb
from vcm_ts_tpu_torch.utils.weights import make_dmc, make_intra

H = W = 64
X0 = jnp.zeros((1, H, W, 3))
Q = np.array([0.1, 0.2], np.float32).reshape(2, 1, 1, 1)  # one row a stream


def _row(a, i):
    return a[i:i + 1]


@pytest.fixture(scope="module")
def codecs():
    """Port codecs, and the frames: two sequences of 4 moving frames,
    stacked along N (frame t is (2, H, W, 3))."""
    ic = IntraCodec(make_intra("cpu"), device="cpu")
    vc = VideoCodec(make_dmc("cpu"), device="cpu")
    ic.update()
    vc.update()
    seqs = [moving_frames(s, 4) for s in (11, 12)]
    xs = [torch.from_numpy(np.concatenate([sq[t] for sq in seqs]))
          for t in range(4)]
    return ic, vc, xs


@pytest.fixture(scope="module")
def batch(codecs):
    """The I-frame and the first P-frame of both sequences coded as a batch
    and each row alone."""
    ic, vc, xs = codecs
    i_b = ic.compress_batch(xs[0], Q)
    r0 = ic.decompress_batch(i_b, H, W, Q)
    p_b = vc.compress_batch(xs[1], make_dpb(r0), Q, Q, True)
    alone = []
    for i in range(2):
        i_s = ic.compress(_row(xs[0], i), _row(Q, i))
        r = ic.decompress(i_s, H, W, _row(Q, i))
        p = vc.compress(_row(xs[1], i), make_dpb(r), _row(Q, i), _row(Q, i),
                        True)
        alone.append({"i": i_s, "r0": r, "p": p})
    return {"i": i_b, "r0": r0, "p": p_b, "alone": alone}


def test_compress_batch_matches_the_jax_engine(codecs, batch):
    """(a) The same weights, frames, DPB and per-row q through the JAX
    engine's compress_batch at N = 2: the same streams, row by row."""
    ic, vc, xs = codecs
    ji, jd = JIntraNoAR(), JDMC(anchor_num=4)
    j_ic = JIntraCodec(ji, flax_params_like(
        lambda: ji.init(jax.random.PRNGKey(0), X0, 1.0), ic.model))
    j_vc = JVideoCodec(jd, flax_params_like(
        lambda: jd.init(jax.random.PRNGKey(0), X0, j_make_dpb(X0), 1.0, 1.0,
                        method="init_all"), vc.model))
    j_ic.update()
    j_vc.update()
    assert j_ic.compress_batch(jnp.asarray(xs[0].numpy()), jnp.asarray(Q)) \
        == batch["i"]
    out = j_vc.compress_batch(
        jnp.asarray(xs[1].numpy()), j_make_dpb(jnp.asarray(batch["r0"])),
        jnp.asarray(Q), jnp.asarray(Q), True)
    assert min(len(s) for s in out["bit_streams"]) > 500, \
        "streams too short to compare"
    assert out["bit_streams"] == batch["p"]["bit_streams"]
    # the port decodes the JAX engine's batched streams to its own recon
    dec = vc.decompress_batch(make_dpb(batch["r0"]), out["bit_streams"], H,
                              W, Q, Q, True)
    np.testing.assert_array_equal(dec["dpb"]["ref_frame"].numpy(),
                                  batch["p"]["dpb"]["ref_frame"].numpy())


def test_compress_batch_rows_equal_compress_alone(batch):
    """(b) Row i of a batch codes to the bytes, and the DPB, of row i
    coded alone, in both engines."""
    for i, a in enumerate(batch["alone"]):
        assert batch["i"][i] == a["i"]
        assert batch["p"]["bit_streams"][i] == a["p"]["bit_stream"]
        for k, v in batch["p"]["dpb"].items():
            assert torch.equal(_row(v, i), a["p"]["dpb"][k]), k


def test_decompress_batch_equals_sequential_decompress(codecs, batch):
    """(c) decompress_batch gives each stream the symbols and recon of
    decompress(return_symbols=True) alone, and the encoder's DPB."""
    ic, vc, _ = codecs
    for i, a in enumerate(batch["alone"]):
        assert torch.equal(_row(batch["r0"], i), a["r0"])
    dpb = make_dpb(batch["r0"])
    got = vc.decompress_batch(dpb, batch["p"]["bit_streams"], H, W, Q, Q,
                              True, return_symbols=True)
    for k, v in got["dpb"].items():
        assert torch.equal(v, batch["p"]["dpb"][k]), k
    for i, a in enumerate(batch["alone"]):
        one = vc.decompress(make_dpb(a["r0"]), a["p"]["bit_stream"], H, W,
                            _row(Q, i), _row(Q, i), True,
                            return_symbols=True)
        for p, (sb, s1) in enumerate(zip(got["symbols"], one["symbols"])):
            np.testing.assert_array_equal(_row(sb, i), s1,
                                          err_msg=f"stream {i} plane {p}")
        for k, v in got["dpb"].items():
            assert torch.equal(_row(v, i), one["dpb"][k]), (i, k)
    a = batch["alone"][0]
    assert "symbols" not in vc.decompress(
        make_dpb(a["r0"]), a["p"]["bit_stream"], H, W, 0.1, 0.1, True)


def test_decode_gop_matches_sequential_decompress(codecs):
    """(d) The overlapped decode_gop (next stream's mv_z decoded during
    stage 1, DPB kept on the device) equals decompress() frame by frame,
    and encode_gop's streams equal compress() frame by frame."""
    ic, vc, xs = codecs
    r0 = ic.decompress(ic.compress(_row(xs[0], 0), 0.5), H, W, 0.5)
    frames = [_row(x, 0) for x in xs[1:]]
    streams, final = vc.encode_gop(frames, make_dpb(r0), 0.7, 0.7)
    dpb, recons = make_dpb(r0), []
    for t, s in enumerate(streams):
        out = vc.compress(frames[t], dpb, 0.7, 0.7, t == 0)
        assert out["bit_stream"] == s, f"frame {t}"
        dec = vc.decompress(dpb, s, H, W, 0.7, 0.7, t == 0)["dpb"]
        assert torch.equal(dec["ref_frame"], out["dpb"]["ref_frame"])
        dpb = dec
        recons.append(dpb["ref_frame"])
    outs, last = vc.decode_gop(make_dpb(r0), streams, H, W, 0.7, 0.7)
    assert len(outs) == 3
    for t, (a, b) in enumerate(zip(outs, recons)):
        assert torch.equal(a, b), f"frame {t}"
    for k, v in last.items():
        assert torch.equal(v, final[k]) and torch.equal(v, dpb[k]), k


def test_concurrent_gop_sessions_equal_one_session(codecs):
    """(e) Two threads of encode_gop, then of decode_gop, through one
    codec: each equals the single-thread result."""
    ic, vc, xs = codecs
    r0 = ic.decompress(ic.compress(_row(xs[0], 1), 0.5), H, W, 0.5)
    dpb0 = make_dpb(r0)
    frames = [_row(x, 1) for x in xs[1:3]]
    ref, _ = vc.encode_gop(frames, dpb0, 0.7, 0.7)
    ref_rec, _ = vc.decode_gop(dpb0, ref, H, W, 0.7, 0.7)
    _, encs = run_sessions(
        [lambda: vc.encode_gop(frames, dpb0, 0.7, 0.7)[0]] * 2, "cpu")
    _, decs = run_sessions(
        [lambda: vc.decode_gop(dpb0, ref, H, W, 0.7, 0.7)[0]] * 2, "cpu")
    for streams, recons in zip(encs, decs):
        assert streams == ref
        assert all(torch.equal(a, b) for a, b in zip(recons, ref_rec))


def test_run_sessions_warms_each_thread_and_raises_its_errors():
    """run_sessions runs warmup() in every session's own thread before the
    clock starts, and a failing warm-up raises its own error (no session
    waits forever for the others)."""
    import threading

    warmed, ran = [], []
    dt, out = run_sessions(
        [lambda k=k: ran.append(threading.get_ident()) or k
         for k in range(3)], "cpu",
        warmup=lambda: warmed.append(threading.get_ident()))
    assert out == [0, 1, 2] and dt >= 0
    assert sorted(warmed) == sorted(ran) and len(set(ran)) == 3

    def bad():
        raise ValueError("warm-up failed")

    with pytest.raises(ValueError, match="warm-up failed"):
        run_sessions([lambda: None] * 2, "cpu", warmup=bad)


def test_launch_counts_survive_concurrent_sessions():
    """Sessions on several threads count their kernel launches without
    losing one (count_launch takes a lock); a short switch interval makes
    a lost read-modify-write likely if it did not."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from vcm_ts_tpu_torch.ops import cuda_build

    before = dict(cuda_build.LAUNCHES)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            list(pool.map(lambda _: [cuda_build.count_launch("warp")
                                     for _ in range(2000)], range(16)))
    finally:
        sys.setswitchinterval(interval)
    assert cuda_build.LAUNCHES["warp"] == before["warp"] + 16 * 2000
    cuda_build.LAUNCHES.update(before)
