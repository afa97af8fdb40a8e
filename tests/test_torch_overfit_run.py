"""PyTorch port, the overfit run (vcm_ts_tpu_torch.overfit_run) against
the JAX package's tools/overfit_run.py: the synthetic clip bit for bit,
the training config's stages and sequence length, the --bf16-check
figures against the JAX tool's expressions on the same weights, and one
tiny CPU run with --bf16-check through the port's do_train, shared by the
stage, checkpoint, bf16 and resume checks (tests/test_torch_train_loop.py
holds do_train itself to the JAX loop, so the JAX loop is not run here).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_warp_twopass import (flax_params_like,  # noqa: F401
                                           one_torch_thread)
from tools import overfit_run as jor
from vcm_ts_tpu.models.dmc import DMC as JDMC
from vcm_ts_tpu.models.dmc import make_dpb as j_make_dpb
from vcm_ts_tpu_torch import overfit_run as tor
from vcm_ts_tpu_torch.models.dmc import DMC
from vcm_ts_tpu_torch.ops.cuda_build import LAUNCHES
from vcm_ts_tpu_torch.train.stages import calc_max_epoch
from vcm_ts_tpu_torch.utils.weights import init_params, load_codec_weights

TINY = [16, 16, 24]
BF16_KEYS = ("bf16_recon_agreement_db", "bpp_f32", "bpp_bf16_rel_delta")


@pytest.mark.parametrize("n,t,size,seed", [(2, 3, 64, 0), (4, 5, 40, 3)])
def test_synthetic_batch_bit_equal(n, t, size, seed):
    got = tor.make_synthetic_batch(n, t, size, seed=seed)
    want = jor.make_synthetic_batch(n, t, size, seed=seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p4", [False, True])
def test_build_cfg_matches_the_jax_tool(p4, tmp_path):
    args = types.SimpleNamespace(lr=1e-4, epochs=2, out=str(tmp_path),
                                 mp=True, grad_accum=2, p4=p4)
    got = tor.build_cfg(args, [16, 16, 24], [85.0, 170.0])
    want = jor.build_cfg(args, [16, 16, 24], [85.0, 170.0])
    assert [list(s) for s in got.SOLVER.STAGES] == [
        list(s) for s in want.SOLVER.STAGES]
    assert len(got.SOLVER.STAGES) == (7 if p4 else 6)
    assert got.DATASET.SEQUENCE_LENGTH == want.DATASET.SEQUENCE_LENGTH \
        == (5 if p4 else 3)
    for key in ("GRAD_CLIP_NORM", "MIXED_PRECISION", "GRAD_ACCUM_STEPS",
                "LAMBDAS"):
        assert getattr(got.SOLVER, key) == getattr(want.SOLVER, key), key
    assert list(got.MODEL.CHANNELS) == list(want.MODEL.CHANNELS)
    assert got.OUTPUT_DIR == want.OUTPUT_DIR
    assert got.TENSORBOARD.BEST_SAMPLES_NUM == 0
    assert got.TENSORBOARD.WORST_SAMPLES_NUM == 0


def _jax_bf16_agreement(params, batch):
    """tools/overfit_run.py:245-267's expressions, on a tiny JAX DMC."""
    model = JDMC(anchor_num=2, channel_mv=TINY[0], channel_N=TINY[1],
                 channel_M=TINY[2])
    bp = jax.tree_util.tree_map(
        lambda v: v.astype(jnp.bfloat16)
        if v.dtype == jnp.float32 else v, params)
    fwd = jax.jit(lambda p, x, dpb: model.apply(p, x, dpb, 1.0, 1.0, True))
    x_f = jnp.asarray(batch[:, 1])
    dpb_f = j_make_dpb(jnp.asarray(batch[:, 0]), TINY[1], TINY[2])
    out_f = fwd(params, x_f, dpb_f)
    dpb_b = {k: v.astype(jnp.bfloat16) for k, v in dpb_f.items()}
    out_b = fwd(bp, x_f.astype(jnp.bfloat16), dpb_b)
    rf = np.asarray(out_f["dpb"]["ref_frame"], np.float32)
    rb = np.asarray(out_b["dpb"]["ref_frame"], np.float32)
    agree_psnr = float(-10 * np.log10(np.mean((rf - rb) ** 2) + 1e-12))
    bpp_f = float(np.mean(np.asarray(out_f["bpp"], np.float32)))
    bpp_b = float(np.mean(np.asarray(out_b["bpp"], np.float32)))
    return {"bf16_recon_agreement_db": agree_psnr, "bpp_f32": bpp_f,
            "bpp_bf16_rel_delta": (bpp_b - bpp_f) / max(bpp_f, 1e-9)}


def _run(argv):
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        result = tor.run(tor.parse_args(argv))
    return result, text.getvalue()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory, one_torch_thread):  # noqa: F811
    """One `--tiny --iters 2 --bf16-check` run on the CPU; beside it, in a
    thread, the JAX tool's bf16 figures on the port's seeded damped
    weights (XLA compiles outside the interpreter lock)."""
    out = str(tmp_path_factory.mktemp("overfit") / "run")
    argv = ["--device", "cpu", "--tiny", "--iters", "2", "--out", out,
            "--bf16-check"]
    damped = init_params(DMC(anchor_num=2, channel_mv=TINY[0],
                             channel_N=TINY[1], channel_M=TINY[2],
                             device="cpu"), seed=0, kernel_scale=0.5)
    jd = JDMC(anchor_num=2, channel_mv=TINY[0], channel_N=TINY[1],
              channel_M=TINY[2])
    x0 = jnp.zeros((2, 64, 64, 3))
    params = flax_params_like(
        lambda: jd.init(jax.random.PRNGKey(0), x0,
                        j_make_dpb(x0, TINY[1], TINY[2]), 1.0, 1.0,
                        method="init_all"), damped)
    batch = tor.make_synthetic_batch(2, 3, 64)
    with ThreadPoolExecutor(1) as pool:
        jax_bf16 = pool.submit(_jax_bf16_agreement, params, batch)
        (rc, record, verdict), text = _run(argv)
        jax_bf16 = jax_bf16.result()
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return dict(out=out, argv=argv, rc=rc, record=record, verdict=verdict,
                text=text, records=records, damped=damped, batch=batch,
                jax_bf16=jax_bf16)


def test_tiny_run_crosses_six_stages(tiny):
    assert tiny["rc"] in (0, 1)  # two iterations a stage need not converge
    verdict = tiny["verdict"]
    assert json.loads(tiny["text"].strip().splitlines()[-1]) == json.loads(
        json.dumps(verdict))
    assert sorted(verdict["stages"]) == list(range(6))
    assert verdict["converged"] == bool(tiny["rc"] == 0)
    assert np.isfinite(verdict["eval_psnr_first"])
    stages = sorted({int(r["value"]) for r in tiny["records"]
                     if r["tag"] == "train/stage"})
    assert stages == list(range(6))
    assert any(r["tag"].startswith("eval/psnr/lambda_")
               for r in tiny["records"])
    epochs = tiny["record"]["epochs"]
    assert [e["stage"] for e in epochs] == list(range(6))
    # do_train's launch counts: none on the CPU (plain versions only)
    assert all(set(e["launches"]) == set(LAUNCHES)
               and not any(e["launches"].values()) for e in epochs)


def test_tiny_run_writes_pt_and_pth(tiny):
    out = tiny["out"]
    for name in [f"model_epoch_{e:03d}.pt" for e in range(6)] + [
            "overfit_final.pt", "overfit_final.pth"]:
        assert os.path.exists(os.path.join(out, name)), name
    blob = torch.load(os.path.join(out, "overfit_final.pt"),
                      weights_only=True)
    assert blob["extra"]["epoch"] == calc_max_epoch(
        tor.build_cfg(tor.parse_args(tiny["argv"]), TINY,
                      [85.0, 170.0]).SOLVER.STAGES) == 6
    model = load_codec_weights(
        DMC(anchor_num=2, channel_mv=16, channel_N=16, channel_M=24,
            device="cpu"), os.path.join(out, "overfit_final.pth"))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, blob["params"][k], rtol=0, atol=0)


def test_bf16_check_reads_the_trained_weights(tiny):
    """--bf16-check's figures are bf16_agreement on the weights the run
    saved (the trained ones, read back from overfit_final.pth)."""
    model = load_codec_weights(
        DMC(anchor_num=2, channel_mv=16, channel_N=16, channel_M=24,
            device="cpu"), os.path.join(tiny["out"], "overfit_final.pth"))
    want = tor.bf16_agreement(model, tiny["batch"], TINY)
    assert {k: tiny["verdict"][k] for k in BF16_KEYS} == want
    assert "bf16-vs-f32 on trained weights" in tiny["text"]


def test_bf16_agreement_matches_the_jax_tool(tiny):
    """bf16_agreement against the JAX tool's expressions on the same
    seeded damped weights and clip, each figure rounded as the tools round
    it. The f32 rate and the relative bf16 rate change agree to the last
    rounded place (1e-5; measured gaps 9e-7 and 3.4e-6 unrounded). The
    recon agreement compares each stack's bf16 forward with its own f32
    one: XLA and PyTorch round bf16 intermediates at other places, so the
    two agreements differ by 1.97 dB here (74.54 port, 72.57 JAX, both
    near bf16's rounding floor); the test allows 3 dB."""
    got = tor.bf16_agreement(tiny["damped"], tiny["batch"], TINY)
    want = tiny["jax_bf16"]
    for key in ("bpp_f32", "bpp_bf16_rel_delta"):
        assert abs(got[key] - round(want[key], 5)) <= 1e-5, (key, got, want)
    assert abs(got["bf16_recon_agreement_db"]
               - round(want["bf16_recon_agreement_db"], 2)) < 3.0, (got,
                                                                    want)


def test_tiny_run_crosses_six_stages_and_resumes(tiny):
    """A second call over the finished run resumes past the end: no step,
    no new metric or epoch checkpoint, the same verdict."""
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        assert tor.main(tiny["argv"]) == tiny["rc"]
    text = text.getvalue()
    assert "resuming from epoch 6" in text
    assert json.loads(text.strip().splitlines()[-1]) == json.loads(
        json.dumps(tiny["verdict"]))
    with open(os.path.join(tiny["out"], "metrics.jsonl")) as f:
        assert len(f.readlines()) == len(tiny["records"])
    assert not os.path.exists(os.path.join(tiny["out"],
                                           "model_epoch_006.pt"))
