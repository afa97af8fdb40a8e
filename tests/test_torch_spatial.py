"""PyTorch port, spatial mode (parallel/spatial.py, the engines'
set_spatial_sharding): one stream's frames split by rows over gloo ranks
(parallel/spawn.start_ranks, one torch thread each), against the JAX
package's unsharded engines and model on the CPU.

Models: the seeded damped inits (utils/weights.init_params, kernel_scale
0.5) of tests/test_engine_spatial.py's widths, IntraNoAR(N=32, anchor_num
4) and DMC(4, 16, 16, 24), carried into flax trees (flax_params_like);
for spatial_forward tests/test_multichip.py's DMC(anchor_num=2, 16, 16,
24). The ranks start first; meanwhile, here, JAX compiles and runs its
unsharded engines and forward in threads, and the port's unsharded codecs
run in this process.

- (a) 2 ranks at 128x128 (test_engine_spatial.py's geometry): the
  spatial I-frame stream and first P-frame stream (from make_dpb of the
  I-frame's source, as JAX's test starts) equal the unsharded JAX
  engine's byte for byte; the spatial decoder decodes them (the same
  bytes) to a recon within atol 2e-2 of the port's unsharded decoder's
  with at least 0.998 of the elements bit-equal (JAX's cross-mode bound);
  within the mode an I + 2 P chain decodes to the encoder's DPB recon bit
  for bit; the chained P stream's length is within 5 % + 16 B of JAX's;
  every rank's bytes are equal.
- (b) The same at 4 ranks and 192x128, where the H/16 planes' 3-row
  slices start on odd rows (the checkerboard's parity is the global
  row's) and the H/32 and H/64 planes do not tile (whole on every rank,
  bit-equal across the ranks); plus encode_gop / decode_gop (the streams
  and recons of the compress / decompress chain) and an I-frame
  compress_batch at N = 2 (each row's stream that of the row alone, the
  batch decode the rows' recons). Cross-mode here: the I-frame recon as
  in (a); the first P-frame's within atol 2e-2 only, since the SE
  layers' means add the ranks' partial sums in another order than one
  mean over the plane (measured: 0.44 of its elements bit-equal, the
  largest gap 2.2e-8).
- (c) spatial_forward on 4 ranks at 64x64, test_multichip.py's inputs
  (smooth frames, damped kernels): ref_frame rtol 1e-3 / atol 1e-4, bpp
  rtol 2e-3 / atol 1e-4 against JAX's unsharded model.apply (its own
  test's tolerances). SpyNet's 1/8 level holds 2 rows a rank there, so
  its 7x7 convs take the gathered plane.
- (d) The windowed plain warps (kernels A and D's plain versions) equal
  the rows of the whole-plane warp bit for bit.
- (e) spatial_shard_tree gives rank r rows [rH/n, (r+1)H/n) of a plane
  that tiles, and a plane that does not whole.
- The engines' entropy-estimated forwards in the mode against the
  port's unsharded engines, with (c)'s tolerances.
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
from tests.torch_parallel_ranks import (spatial_codec_case,
                                        spatial_forward_case, spatial_jobs)
from vcm_ts_tpu.codec.engine import IntraCodec as JIntraCodec
from vcm_ts_tpu.codec.engine import VideoCodec as JVideoCodec
from vcm_ts_tpu.models.dmc import DMC as JDMC
from vcm_ts_tpu.models.dmc import make_dpb as j_make_dpb
from vcm_ts_tpu.models.intra import IntraNoAR as JIntraNoAR
from vcm_ts_tpu_torch.models.dmc import DMC
from vcm_ts_tpu_torch.models.intra import IntraNoAR
from vcm_ts_tpu_torch.ops.warp import warp_plain
from vcm_ts_tpu_torch.ops.warp_twopass import warp_twopass_plain
from vcm_ts_tpu_torch.parallel.spatial import tiles
from vcm_ts_tpu_torch.parallel.spawn import start_ranks
from vcm_ts_tpu_torch.utils.weights import init_params

CH = (16, 16, 24)
IQ, PQ = 0.1, 0.1  # fine: streams of thousands of bytes
GEOMETRY = {"a": (128, 128, 2), "b": (192, 128, 4)}
RECON_ATOL, RECON_EXACT = 2e-2, 0.998  # JAX's cross-mode bound


def _frame(h, w, seed):
    """test_engine_spatial.py's frames: 8x8 blocks of seeded noise."""
    rng = np.random.default_rng(seed)
    base = rng.random((1, h // 8, w // 8, 3)).astype(np.float32)
    return np.kron(base, np.ones((1, 8, 8, 1))).astype(np.float32)


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _models():
    return (init_params(IntraNoAR(N=32, anchor_num=4, device="cpu"), seed=0,
                        kernel_scale=0.5),
            init_params(DMC(anchor_num=4, channel_mv=CH[0], channel_N=CH[1],
                            channel_M=CH[2], device="cpu"), seed=1,
                        kernel_scale=0.5))


def _codec_spec(intra, dmc, case, **kw):
    h, w, _ = GEOMETRY[case]
    spec = dict(intra={"N": 32, "anchors": 4, "state": _state(intra)},
                dmc={"channels": CH, "anchors": 4, "state": _state(dmc)},
                frames=[_frame(h, w, s) for s in (3, 5, 6)], h=h, w=w, iq=IQ,
                pq=PQ)
    spec.update(kw)
    return spec


def _forward_inputs():
    """test_multichip.py's smooth pair at 64x64."""
    rng = np.random.default_rng(0)
    base = rng.random((1, 8, 8, 3)).astype(np.float32)
    x = np.kron(base, np.ones((1, 8, 8, 1))).astype(np.float32)
    ref = np.kron(np.roll(base, 1, 2), np.ones((1, 8, 8, 1))).astype(
        np.float32)
    return x, ref


def _jax_streams(intra, dmc, specs):
    """JAX's unsharded engines on the port's weights: for each spec, the
    I-frame stream and the P-frames chained from make_dpb(frames[0])."""
    ji, jd = JIntraNoAR(N=32, anchor_num=4), JDMC(
        anchor_num=4, channel_mv=CH[0], channel_N=CH[1], channel_M=CH[2])
    x0 = jnp.zeros((1, 64, 64, 3))
    ip = flax_params_like(lambda: ji.init(jax.random.PRNGKey(0), x0, 1.0),
                          intra)
    dp = flax_params_like(
        lambda: jd.init(jax.random.PRNGKey(0), x0,
                        j_make_dpb(x0, CH[1], CH[2]), 1.0, 1.0,
                        method="init_all"), dmc)
    jic, jvc = JIntraCodec(ji, ip), JVideoCodec(jd, dp)
    jic.update()
    jvc.update()
    out = {}
    for case, spec in specs.items():
        frames = [jnp.asarray(f) for f in spec["frames"]]
        dpb = j_make_dpb(frames[0], CH[1], CH[2])
        p = []
        for t in (1, 2):
            enc = jvc.compress(frames[t], dpb, PQ, PQ, is_first_p=t == 1)
            dpb = enc["dpb"]
            p.append(enc["bit_stream"])
        out[case] = {"i": jic.compress(frames[0], IQ), "p": p}
    return out


def _jax_forward(dmc, x, ref):
    model = JDMC(anchor_num=2, channel_mv=CH[0], channel_N=CH[1],
                 channel_M=CH[2])
    x0 = jnp.zeros((1, 64, 64, 3))
    params = flax_params_like(
        lambda: model.init(jax.random.PRNGKey(0), x0,
                           j_make_dpb(x0, CH[1], CH[2]), 1.0, 1.0,
                           method="init_all"), dmc)
    out = jax.jit(lambda p, a, d: model.apply(p, a, d, 1.0, 1.0, True,
                                              training=False))(
        params, jnp.asarray(x), j_make_dpb(jnp.asarray(ref), CH[1], CH[2]))
    return {"ref_frame": np.asarray(out["dpb"]["ref_frame"]),
            "bpp": np.asarray(out["bpp"])}


@pytest.fixture(scope="module")
def runs(one_torch_thread):  # noqa: F811
    intra, dmc = _models()
    fwd_dmc = init_params(DMC(anchor_num=2, channel_mv=CH[0],
                              channel_N=CH[1], channel_M=CH[2],
                              device="cpu"), seed=0, kernel_scale=0.5)
    x, ref = _forward_inputs()
    specs = {"a": _codec_spec(intra, dmc, "a"),
             "b": _codec_spec(intra, dmc, "b", gop=True, batch=True,
                              batch_q=[0.1, 0.3])}
    fwd_spec = {"dmc": {"channels": CH, "anchors": 2,
                        "state": _state(fwd_dmc)}, "x": x, "ref": ref}
    with start_ranks(spatial_codec_case, 2, specs["a"]) as two, \
            start_ranks(spatial_jobs, 4, specs["b"], fwd_spec) as four, \
            ThreadPoolExecutor(2) as pool:
        # XLA compiles outside the interpreter lock: JAX overlaps the
        # port's unsharded runs here and the ranks
        jax_jobs = {"streams": pool.submit(_jax_streams, intra, dmc, specs),
                    "forward": pool.submit(_jax_forward, fwd_dmc, x, ref)}
        plain = {case: spatial_codec_case(spec)
                 for case, spec in specs.items()}
        jax_side = {k: f.result() for k, f in jax_jobs.items()}
        res2, res4 = two.join(), four.join()
    return {"jax": jax_side, "plain": plain, "specs": specs,
            "a": [r["result"] for r in res2],
            "b": [r["result"]["codec"] for r in res4],
            "c": [r["result"]["forward"] for r in res4]}


@pytest.mark.parametrize("case", ["a", "b"])
def test_streams_equal_jax_unsharded_engine(runs, case):
    """The spatial I-frame and first P-frame streams are the unsharded
    JAX engine's, byte for byte, on every rank; the chained second
    P-frame's length within 5 % + 16 B of JAX's."""
    want = runs["jax"]["streams"][case]
    assert min(len(want["i"]), len(want["p"][0])) > 1000  # teeth
    for r in runs[case]:
        assert r["i_stream"] == want["i"]
        assert r["p_enc"][0]["stream"] == want["p"][0]
        got2, want2 = len(r["p_enc"][1]["stream"]), len(want["p"][1])
        assert abs(got2 - want2) <= 0.05 * want2 + 16, (got2, want2)


@pytest.mark.parametrize("case", ["a", "b"])
def test_every_rank_writes_the_same_bytes(runs, case):
    first = runs[case][0]
    for r in runs[case][1:]:
        assert r["i_stream"] == first["i_stream"]
        assert [p["stream"] for p in r["p_enc"]] == \
            [p["stream"] for p in first["p_enc"]]


@pytest.mark.parametrize("case", ["a", "b"])
def test_within_mode_chain_decodes_bit_exact(runs, case):
    """I + 2 P: the spatial decoder's recon of each P-frame is the spatial
    encoder's DPB recon, bit for bit, on every rank."""
    for r in runs[case]:
        for t, (enc, dec) in enumerate(zip(r["p_enc"], r["p_dec"])):
            np.testing.assert_array_equal(dec, enc["recon"],
                                          err_msg=f"P-frame {t + 1}")


def _near(got, want, exact: bool, what: str):
    np.testing.assert_allclose(got, want, rtol=0, atol=RECON_ATOL,
                               err_msg=what)
    if exact:
        share = float(np.mean(got == want))
        assert share >= RECON_EXACT, f"{what}: {share:.4f} bit-equal"


@pytest.mark.parametrize("case", ["a", "b"])
def test_cross_mode_recon_within_bound(runs, case):
    """The spatial decoder on the unsharded streams (equal bytes, the
    test above) against the port's unsharded decoder: the I-frame within
    atol 2e-2 with at least 0.998 of the elements bit-equal; the first
    P-frame too at 2 ranks, at 4 within atol 2e-2 (module docstring)."""
    plain = runs["plain"][case]
    for r in runs[case]:
        assert r["i_stream"] == plain["i_stream"]
        assert r["p_enc"][0]["stream"] == plain["p_enc"][0]["stream"]
        _near(r["i_recon"], plain["i_recon"], True, "I-frame")
        _near(r["p_dec"][0], plain["p_dec"][0], case == "a", "P-frame 1")


@pytest.mark.parametrize("case", ["a", "b"])
def test_engine_forwards_match_unsharded(runs, case):
    """The engines' entropy-estimated forward in the mode (IntraCodec's
    on frame 0, VideoCodec's on frame 1 from make_dpb(frame 0)) against
    the port's unsharded engines: spatial_forward's tolerances (c)."""
    plain = runs["plain"][case]["forward"]
    for r in runs[case]:
        got = r["forward"]
        for img, bpp in (("x_hat", "i_bpp"), ("ref_frame", "p_bpp")):
            np.testing.assert_allclose(got[img], plain[img], rtol=1e-3,
                                       atol=1e-4)
            np.testing.assert_allclose(got[bpp], plain[bpp], rtol=2e-3,
                                       atol=1e-4)


def test_planes_that_do_not_tile_are_whole_and_equal_across_ranks(runs):
    """At 192x128 on 4 ranks the mv hyper encoder's H/32 (6 rows) and
    H/64 (3 rows) outputs are whole on every rank and bit-equal."""
    h, w, n = GEOMETRY["b"]
    assert not tiles(h // 32, n) and not tiles(h // 64, n)
    first = runs["b"][0]["whole_planes"]
    assert first[6].shape[2] == h // 32 and first[8].shape[2] == h // 64
    for r in runs["b"][1:]:
        for k, v in r["whole_planes"].items():
            np.testing.assert_array_equal(v, first[k], err_msg=str(k))


def test_encode_gop_and_decode_gop_match_the_frame_calls(runs):
    for r in runs["b"]:
        gop = r["gop"]
        assert gop["streams"] == [p["stream"] for p in r["p_enc"]]
        np.testing.assert_array_equal(gop["enc_recon"],
                                      r["p_enc"][-1]["recon"])
        for t, (a, b) in enumerate(zip(gop["dec"], r["p_dec"])):
            np.testing.assert_array_equal(a, b, err_msg=f"P-frame {t + 1}")


def test_compress_batch_rows_code_as_alone(runs):
    """compress_batch at N = 2 (two frames, two q rows): each row's stream
    is compress() of the row alone, and equals the unsharded batch's; the
    batch decode's first row is the I-frame recon of (b)'s frame 0."""
    plain = runs["plain"]["b"]["batch"]
    for r in runs["b"]:
        assert r["batch"]["streams"] == r["batch"]["alone"]
        assert r["batch"]["streams"] == plain["streams"]
        assert r["batch"]["recon"].shape[0] == 2
        np.testing.assert_array_equal(r["batch"]["recon"][:1],
                                      r["i_recon"])


def test_spatial_forward_matches_jax_unsharded_apply(runs):
    want = runs["jax"]["forward"]
    for r in runs["c"]:
        np.testing.assert_allclose(r["ref_frame"], want["ref_frame"],
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(r["bpp"], want["bpp"], rtol=2e-3,
                                   atol=1e-4)
        assert r["collectives"]["halo"] > 0
        assert r["collectives"]["gather_plane"] > 0


@pytest.mark.parametrize("case", ["a", "b"])
def test_inputs_are_split_by_rows(runs, case):
    """Rank r holds rows [rH/n, (r+1)H/n) of the frame; the H/64 plane of
    (b) (3 rows over 4 ranks) is whole, (a)'s (2 rows over 2) split."""
    h, w, n = GEOMETRY[case]
    x = runs["specs"][case]["frames"][0]
    for rank, r in enumerate(runs[case]):
        k = h // n
        np.testing.assert_array_equal(r["shard"]["x"],
                                      x[:, rank * k:(rank + 1) * k])
        small = r["shard"]["small"]
        assert small.shape[1] == (h // 64 // n if tiles(h // 64, n)
                                  else h // 64)


# ------------------------------------------------------------- (d) windows
def _flow(n, h, w, seed, scale):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n, 2, h, w), generator=g) * scale).contiguous(
        memory_format=torch.channels_last)


def _image(n, c, h, w, seed, dtype):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, c, h, w), generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("kind", ["exact", "exact packed", "twopass"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_plain_warps_are_rows_of_the_whole_warp(kind, dtype):
    """Windows at the top and bottom edges and at random offsets, flows
    reaching past the frame (displacements up to about 3 x 6 pixels):
    bit for bit the whole warp's rows."""
    n, h, w, d = 2, 40, 24, 6
    flow = _flow(n, h, w, 0, 6.0).to(dtype)
    ims = [_image(n, c, h, w, 1 + c, dtype) for c in (
        (3, 16) if kind == "exact packed" else (16,))]
    rng = np.random.default_rng(2)
    windows = [(0, 7), (h - 5, 5), (0, h)] + [
        (int(r0), int(hl)) for r0, hl in
        zip(rng.integers(0, h - 8, 3), rng.integers(1, 8, 3))]
    if kind == "twopass":
        whole = [warp_twopass_plain(ims[0], flow, d)]
    else:
        whole = warp_plain(ims, flow)
    for r0, hl in windows:
        f = flow[:, :, r0:r0 + hl].contiguous(memory_format=torch.channels_last)
        if kind == "twopass":
            got = [warp_twopass_plain(ims[0], f, d, row0=r0)]
        else:
            got = warp_plain(ims, f, row0=r0)
        for a, b in zip(got, whole):
            assert torch.equal(a, b[:, :, r0:r0 + hl]), (r0, hl)
