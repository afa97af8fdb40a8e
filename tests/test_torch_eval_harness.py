"""PyTorch port, codec eval harness: vcm_ts_tpu_torch's test_video,
benchmark_videos_decoding, bd_rate and benchmark_plot against the root
scripts of the JAX package, on the CPU.

The codecs are the tiny ones of tests/test_eval_harness.py (IntraNoAR
N=32, DMC 16/16/24 with 4 anchors) on the port's seeded damped init (every
weight x 0.5), carried into the JAX models (`flax_params_like`). Frames: a
60x60 4-frame PNG sequence (padded to 64x64 by the harness).

Tolerances:
- real streams: every .bin byte-identical, so the bits are equal; PSNR
  within 1e-3 dB (f32 recons of two stacks); MS-SSIM within 1e-5 (at
  60x60 both packages give NaN: five scales need 161 pixels; the metric is
  held at 176x176 in the plot-metrics test);
- entropy-estimated bits rtol 1e-3 (XLA's f32 erf is 2 ulp off in the
  tail, ROADMAP's numerics facts);
- the port's batched run equals its sequential run exactly;
- decoded PNGs within one level (an f32 recon rounds to uint8);
- BD metrics within 1e-9; plot metrics within 1e-6 (mAP, OCR, MS-SSIM),
  PSNR within 1e-4 dB (an f32 mean over 93k values summed in two orders:
  8e-6 relative, 3.6e-5 dB at 36 dB measured).
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_warp_twopass import (flax_params_like,  # noqa: F401
                                           one_torch_thread)
from vcm_ts_tpu.codec.engine import IntraCodec as JIntraCodec
from vcm_ts_tpu.codec.engine import VideoCodec as JVideoCodec
from vcm_ts_tpu.models.dmc import DMC as JDMC
from vcm_ts_tpu.models.dmc import make_dpb as j_make_dpb
from vcm_ts_tpu.models.intra import IntraNoAR as JIntraNoAR
from vcm_ts_tpu.utils import common as jcommon
from vcm_ts_tpu_torch import bd_rate as tbd
from vcm_ts_tpu_torch import benchmark_plot as tbp
from vcm_ts_tpu_torch import benchmark_videos_decoding as tbvd
from vcm_ts_tpu_torch import test_video as ttv
from vcm_ts_tpu_torch.codec.engine import IntraCodec, VideoCodec
from vcm_ts_tpu_torch.models.dmc import DMC
from vcm_ts_tpu_torch.models.intra import IntraNoAR
from vcm_ts_tpu_torch.utils import common as tcommon
from vcm_ts_tpu_torch.utils.weights import init_params

pytestmark = pytest.mark.usefixtures("one_torch_thread")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CH = (16, 16, 24)
FRAMES_60 = 4


def _load_root(name):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jtv():
    return _load_root("test_video")


@pytest.fixture(scope="module")
def codecs():
    """{"jax": (intra, video), "port": (intra, video)}, tables built."""
    ti = init_params(IntraNoAR(N=32, device="cpu"), seed=0, kernel_scale=0.5)
    td = init_params(DMC(anchor_num=4, channel_mv=CH[0], channel_N=CH[1],
                         channel_M=CH[2], device="cpu"), seed=1,
                     kernel_scale=0.5)
    ji, jd = JIntraNoAR(N=32), JDMC(anchor_num=4, channel_mv=CH[0],
                                    channel_N=CH[1], channel_M=CH[2])
    x0 = jnp.zeros((1, 64, 64, 3))
    ip = flax_params_like(lambda: ji.init(jax.random.PRNGKey(0), x0, 1.0), ti)
    dp = flax_params_like(
        lambda: jd.init(jax.random.PRNGKey(0), x0, j_make_dpb(x0, CH[1],
                                                              CH[2]),
                        1.0, 1.0, method="init_all"), td)
    out = {"jax": (JIntraCodec(ji, ip), JVideoCodec(jd, dp)),
           "port": (IntraCodec(ti.eval(), device="cpu"),
                    VideoCodec(td.eval(), device="cpu"))}
    for pair in out.values():
        for c in pair:
            c.update()
    return out


def _write_seq(d, n, h, w, seed, pad=1):
    rng = np.random.default_rng(seed)
    base = rng.random((h // 4 + 1, w // 4 + 1, 3))
    base = np.kron(base, np.ones((4, 4, 1)))[:h, :w]
    os.makedirs(d, exist_ok=True)
    for t in range(n):
        img = np.clip(np.roll(base, 2 * t, axis=1) * 255
                      + rng.normal(0, 3, base.shape), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(d, f"im{str(t + 1).zfill(pad)}.png"))
    return str(d)


@pytest.fixture(scope="module")
def seq60(tmp_path_factory):
    return _write_seq(tmp_path_factory.mktemp("seq60"), FRAMES_60, 60, 60, 0)


def _task(img_path, q, bin_folder=None, gop=2, rate_idx=0):
    t = {"rate_idx": rate_idx, "frame_num": FRAMES_60, "gop_size": gop,
         "img_path": img_path, "i_frame_q_scale": q[0],
         "p_frame_y_q_scale": q[1], "p_frame_mv_y_q_scale": q[2],
         "write_stream": bin_folder is not None, "save_decoded_frame": False}
    if bin_folder is not None:
        os.makedirs(bin_folder, exist_ok=True)
        t["bin_folder"] = bin_folder
    return t


FRAME_KEYS = ("frame_type", "frame_bpp", "frame_psnr", "frame_msssim")
Q_SEQ = (0.1, 0.12, 0.15)  # I, P y, P mv


def _bins(folder):
    return [open(os.path.join(folder, f"{i}.bin"), "rb").read()
            for i in range(FRAMES_60)]


def _beside(fn, *args):
    """fn(*args) in a thread (XLA compiles and runs the JAX engines outside
    the interpreter lock, so the port's run here overlaps it); returns its
    future."""
    pool = ThreadPoolExecutor(1)
    try:
        return pool.submit(fn, *args)
    finally:
        pool.shutdown(wait=False)


def test_run_test_streams_byte_identical(tmp_path, codecs, seq60, jtv):
    j_run = _beside(jtv.run_test, codecs["jax"][1], codecs["jax"][0],
                    _task(seq60, Q_SEQ, str(tmp_path / "jax")))
    t_log = ttv.run_test(codecs["port"][1], codecs["port"][0],
                         _task(seq60, Q_SEQ, str(tmp_path / "port")))
    j_log = j_run.result()
    jb, tb = _bins(str(tmp_path / "jax")), _bins(str(tmp_path / "port"))
    assert min(len(b) for b in tb) > 40
    for i, (a, b) in enumerate(zip(tb, jb)):
        assert a == b, f"frame {i}: .bin differs"
    assert t_log["frame_type"] == j_log["frame_type"] == [0, 1, 0, 1]
    assert t_log["frame_bpp"] == j_log["frame_bpp"]
    assert t_log["frame_pixel_num"] == j_log["frame_pixel_num"] == 3600
    np.testing.assert_allclose(t_log["frame_psnr"], j_log["frame_psnr"],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(t_log["frame_msssim"], j_log["frame_msssim"],
                               rtol=0, atol=1e-5)
    assert set(t_log) == set(j_log)


def test_run_test_entropy_estimated(codecs, seq60, jtv):
    j_run = _beside(jtv.run_test, codecs["jax"][1], codecs["jax"][0],
                    _task(seq60, Q_SEQ, gop=3))
    t_log = ttv.run_test(codecs["port"][1], codecs["port"][0],
                         _task(seq60, Q_SEQ, gop=3))
    j_log = j_run.result()
    assert t_log["frame_type"] == j_log["frame_type"] == [0, 1, 1, 0]
    np.testing.assert_allclose(t_log["frame_bpp"], j_log["frame_bpp"],
                               rtol=1e-3)
    np.testing.assert_allclose(t_log["frame_psnr"], j_log["frame_psnr"],
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("write_stream", [True, False],
                         ids=["write_stream", "estimated"])
def test_run_test_batched(tmp_path, codecs, seq60, jtv, write_stream):
    """The port's batched run equals its sequential run (logs, .bin files);
    its bits equal the JAX batched run's (estimated: rtol 1e-3)."""
    qs = ((0.7, 0.8, 0.9), (1.3, 1.2, 1.1))

    def tasks(tag):
        return [_task(seq60, q, str(tmp_path / f"{tag}{r}") if write_stream
                      else None, rate_idx=r) for r, q in enumerate(qs)]

    j_run = _beside(jtv.run_test_batched, codecs["jax"][1],
                    codecs["jax"][0], tasks("jbat"))
    seq = [ttv.run_test(codecs["port"][1], codecs["port"][0], t)
           for t in tasks("seq")]
    bat = ttv.run_test_batched(codecs["port"][1], codecs["port"][0],
                               tasks("bat"))
    jbat = j_run.result()
    for r in range(len(qs)):
        for k in FRAME_KEYS:
            np.testing.assert_array_equal(bat[r][k], seq[r][k], err_msg=k)
        if write_stream:
            assert _bins(str(tmp_path / f"bat{r}")) == \
                _bins(str(tmp_path / f"seq{r}"))
            assert bat[r]["frame_bpp"] == jbat[r]["frame_bpp"]
        else:
            np.testing.assert_allclose(bat[r]["frame_bpp"],
                                       jbat[r]["frame_bpp"], rtol=1e-3)
        np.testing.assert_allclose(bat[r]["frame_psnr"],
                                   jbat[r]["frame_psnr"], rtol=0, atol=1e-3)


def test_log_json_text_byte_equal(tmp_path):
    rng = np.random.default_rng(3)
    types = [0, 1, 1, 0, 1]
    args = (5, types, list(rng.random(5) * 1e4), list(rng.random(5) * 40),
            list(rng.random(5)), 3600, 1.234567891)
    texts = []
    for mod in (jcommon, tcommon):
        log = {"A": {"s": {"000": mod.generate_log_json(*args)}}}
        path = tmp_path / f"{mod.__name__}.json"
        with open(path, "w") as f:
            mod.dump_json(log, f, float_digits=6, indent=2)
        texts.append(path.read_bytes())
    assert texts[0] == texts[1]
    assert tcommon.scale_list_to_str([0.5, 1.25]) == \
        jcommon.scale_list_to_str([0.5, 1.25])


def test_decoding_sweep_matches_jax(tmp_path, codecs, seq60):
    """benchmark_videos_decoding.run_test (the DCVC branch's per rate point
    work): the same per-frame log and decoded PNGs within one level."""
    jbvd = _load_root("benchmark_videos_decoding")
    images = _write_seq(tmp_path / "images", 3, 60, 60, 1, pad=5)
    logs, frames = [], []
    for mod, (ic, vc) in ((jbvd, codecs["jax"]), (tbvd, codecs["port"])):
        out = tmp_path / mod.__name__
        mod.run_test(vc, ic, dict(
            rate_idx=1, i_frame_q_scale=0.8, p_frame_y_q_scale=0.9,
            p_frame_mv_y_q_scale=1.0, gop=2, frame_num=3, img_path=images,
            decoded_frame_folder=str(out)))
        with open(out / "quality_1.json") as f:
            logs.append(json.load(f))
        frames.append([np.asarray(Image.open(out / "quality_1" /
                                             f"im{i:05d}.png"), np.int16)
                       for i in (1, 2, 3)])
    j_log, t_log = logs
    assert set(t_log) == set(j_log)
    for k in ("gop", "i_frame_num", "p_frame_num", "frame_type"):
        assert t_log[k] == j_log[k], k
    for k in ("avg_i_frame_bpp", "avg_p_frame_bpp", "avg_bpp", "frame_bpp"):
        np.testing.assert_allclose(t_log[k], j_log[k], rtol=1e-3, err_msg=k)
    for a, b in zip(*frames):
        assert np.abs(a - b).max() <= 1


def _metrics_tree(rng, gop_names=False):
    codecs = (["DCVC gop8", "DCVC gop16", "HEVC gop8", "HEVC gop16"]
              if gop_names else ["HEVC veryslow", "DCVC", "Other"])
    out = {}
    for c in codecs:
        out[c] = {}
        gop = int(c.split("gop")[1]) if gop_names else 32
        for v in ("v1", "v2"):
            bpp = np.sort(rng.random(4) * 0.3 + 0.02)
            psnr = np.sort(rng.random(4) * 8 + 30)
            maps = np.sort(rng.random(4) * 20 + 50)
            out[c][v] = [{"bpp": float(b), "psnr": float(p), "gop": gop,
                          "mean_ap": {"yolo_detection": {"map": float(m)}}}
                         for b, p, m in zip(bpp, psnr, maps)]
    return out


@pytest.mark.parametrize("mode", ["codecs", "gop"])
def test_bd_metrics_match_jax(tmp_path, mode):
    jbd = _load_root("bd_rate")
    from vcm_ts_tpu.eval import bd_metrics as jbm
    from vcm_ts_tpu_torch.eval import bd_metrics as tbm

    metrics = _metrics_tree(np.random.default_rng(4), mode == "gop")
    texts = []
    for mod, d in ((jbd, tmp_path / "jax"), (tbd, tmp_path / "port")):
        os.makedirs(d)
        if mode == "gop":
            mod.compute_bd_gop(metrics, "8", "pchip", str(d))
        else:
            mod.compute_bd(metrics, "HEVC veryslow", "pchip", str(d))
        texts.append((d / "bd_metrics.txt").read_text())
    assert texts[0] == texts[1] and texts[1].count("BD-Rate") >= 8
    a, b = metrics["DCVC" if mode == "codecs" else "DCVC gop8"]["v1"], \
        metrics["Other" if mode == "codecs" else "DCVC gop16"]["v1"]
    args = ([e["bpp"] for e in a], [e["psnr"] for e in a],
            [e["bpp"] for e in b], [e["psnr"] for e in b])
    for method in ("pchip", "akima", "cubic"):
        for fn in ("bd_rate", "bd_psnr"):
            assert abs(getattr(tbm, fn)(*args, method=method)
                       - getattr(jbm, fn)(*args, method=method)) <= 1e-9


def _detector(rgb, labels_start_index):
    """A fixed numpy detector: boxes around the brightest 16x16 blocks."""
    g = np.asarray(rgb, np.float64).mean(-1)
    h, w = g.shape
    blocks = g[:h // 16 * 16, :w // 16 * 16].reshape(h // 16, 16, w // 16,
                                                      16).mean((1, 3))
    order = np.argsort(blocks.ravel())[::-1][:3]
    ys, xs = np.unravel_index(order, blocks.shape)
    boxes = np.stack([xs * 16, ys * 16, xs * 16 + 20, ys * 16 + 18],
                     1).astype(np.float32)
    return {"boxes": boxes,
            "labels": (np.arange(3) % 2 + labels_start_index).astype(
                np.int64),
            "scores": blocks.ravel()[order].astype(np.float32)}


def test_plot_metrics_match_jax(tmp_path):
    """benchmark_plot.get_metrics over a decoded tree (2 qualities of two
    176x176 frames) with the fixed detector and OCR: mAP, OCR and MS-SSIM
    equal JAX's within 1e-6, PSNR within 1e-4 dB."""
    jbp = _load_root("benchmark_plot")
    rng = np.random.default_rng(5)
    src = _write_seq(tmp_path / "src", 2, 176, 176, 6, pad=5)
    dataset_imgs = [np.asarray(Image.open(os.path.join(
        src, f"im{i:05d}.png")), np.float32) / 255 for i in (1, 2)]
    decod = tmp_path / "decoded" / "codec" / "vid"
    for q in range(2):
        d = decod / f"quality_{q}"
        os.makedirs(d)
        for i, img in enumerate(dataset_imgs):
            noisy = np.clip(img * 255 + rng.normal(0, 4 + 4 * q, img.shape),
                            0, 255).astype(np.uint8)
            Image.fromarray(noisy).save(d / f"im{i + 1:05d}.png")
        with open(decod / f"quality_{q}.json", "w") as f:
            json.dump({"gop": 8, "avg_bpp": 0.1 * (q + 1),
                       "frame_bpp": [0.1, 0.2]}, f)
    gt = [_detector(img, 1) for img in dataset_imgs]
    for g in gt:
        g["boxes"] = g["boxes"] + 2
        del g["scores"]

    def ocr(rgb, boxes):
        return ["AB1" if float(np.mean(rgb)) > 0.4 else "AB7"
                for _ in range(len(boxes))]

    dataset = {"vid": {
        "images": dataset_imgs,
        "annotations": {
            "object_detection": gt,
            "license_recognition": [
                {"boxes": np.array([[1, 1, 9, 9]], np.float32),
                 "texts": ["AB1"]} for _ in dataset_imgs]},
        "classes": [1, 2], "class_names": ["car", "bus"], "mean_ap": 0}}
    dets = {"rcnn": _detector, "yolo": _detector}
    results = []
    for mod in (jbp, tbp):
        for f in decod.parent.glob("*/*_metrics.json"):
            f.unlink()
        kw = {} if mod is jbp else {"device": "cpu"}
        results.append(mod.get_metrics(str(tmp_path / "decoded"), dets, ocr,
                                       dataset, True, 1, **kw))
    want, got = (r["codec"]["vid"] for r in results)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["quality"] == w["quality"] and g["bpp"] == w["bpp"]
        assert np.isfinite(g["ssim"])
        assert abs(g["psnr"] - w["psnr"]) <= 1e-4
        assert abs(g["ssim"] - w["ssim"]) <= 1e-6
        assert g["ocr_results"] == w["ocr_results"]
        assert set(g["mean_ap"]) == set(w["mean_ap"]) == {"rcnn",
                                                          "yolo_detection"}
        for m in g["mean_ap"]:
            for k in ("map", "map_50"):
                assert abs(g["mean_ap"][m][k] - w["mean_ap"][m][k]) <= 1e-6
            assert g["mean_ap"][m]["class_map"].keys() == \
                w["mean_ap"][m]["class_map"].keys()


def test_unported_branches_raise(tmp_path, monkeypatch):
    # --fleet runs (tests/test_torch_parallel.py) with --batch_rates only
    with pytest.raises(SystemExit, match="--batch_rates"):
        ttv.main(["--test_config", "x.json", "--output_path", "o.json",
                  "--fleet", "1", "--device", "cpu"])
    # the Faster-RCNN branch runs (tests/test_torch_rcnn.py) but its
    # checkpoint is not in the repository
    with pytest.raises(FileNotFoundError,
                       match="fasterrcnn_resnet50_fpn_v2_coco"):
        tbp.build_rcnn("cpu")
    monkeypatch.setattr(tbvd.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        tbvd.decod_hevc(str(tmp_path), str(tmp_path), 2, 8, {})
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        tbp.plot_graphs({}, {}, str(tmp_path), True, False, "en")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tbd.main(["--decod-dir", str(tmp_path), "--out-path",
                      str(tmp_path)])


def test_cli_runs_on_cpu(tmp_path):
    """python -m vcm_ts_tpu_torch.test_video --device cpu: the published
    widths (seeded damped init), 64x64, 2 frames, 1 rate, real streams."""
    _write_seq(tmp_path / "data" / "cls" / "seqA", 2, 64, 64, 2)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"root_path": str(tmp_path / "data"),
                               "test_classes": {"C": {
                                   "test": 1, "base_path": "cls",
                                   "sequences": {"seqA": {"gop": 2,
                                                          "frames": 2}}}}}))
    out = tmp_path / "out.json"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # one core, as the test workers share them
    r = subprocess.run(
        [sys.executable, "-m", "vcm_ts_tpu_torch.test_video", "--device",
         "cpu", "--test_config", str(cfg), "--output_path", str(out),
         "--rate_num", "1", "--write_stream", "1", "--stream_path",
         str(tmp_path / "bin")], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    log = json.loads(out.read_text())["C"]["seqA"]["000"]
    assert log["frame_type"] == [0, 1] and all(b > 0 for b in
                                               log["frame_bpp"])
    assert sorted(os.listdir(tmp_path / "bin" / "seqA" / "0")) == \
        ["0.bin", "1.bin"]


def test_profiling_helpers(tmp_path):
    """HostTimers reports as the JAX package's; device_trace writes a
    Chrome trace of the ops it wraps."""
    from vcm_ts_tpu.utils.profiling import HostTimers as JHostTimers
    from vcm_ts_tpu_torch.utils.profiling import HostTimers, device_trace

    reports = []
    for cls in (JHostTimers, HostTimers):
        timers = cls()
        for name in ("i_frame", "p_frame", "p_frame"):
            with timers.track(name):
                pass
        reports.append(timers.report())
    assert {k: v["count"] for k, v in reports[0].items()} == \
        {k: v["count"] for k, v in reports[1].items()} == {"i_frame": 1,
                                                          "p_frame": 2}
    assert set(reports[1]["p_frame"]) == set(reports[0]["p_frame"])
    with device_trace(str(tmp_path / "trace")):
        torch.ones(8, 8).matmul(torch.ones(8, 8))
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
