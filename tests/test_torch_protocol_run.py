"""PyTorch port, the protocol run (vcm_ts_tpu_torch.protocol_run)
against the JAX package's tools/protocol_run.py.

The clip: gen_sequence draws without cv2; its frames equal the JAX tool's
(cv2.resize INTER_CUBIC of float64 noise grids, cv2.imwrite in BGR)
exactly, every pixel of every frame (measured: 0 of 4 x 72 x 96 x 3
values differ; the float cubic resize equals cv2's bit for bit). The run:
the port's harness in this process at 64x64, 3 frames, GOP 2, one rate
point, real streams.
"""

from __future__ import annotations

import json
import os
import shutil

import cv2
import numpy as np
import pytest

from tests.test_torch_warp_twopass import one_torch_thread  # noqa: F401
from tools import protocol_run as jpr
from vcm_ts_tpu_torch import protocol_run as tpr
from vcm_ts_tpu_torch.codec.png_io import imread


@pytest.mark.parametrize("src,dst", [((5, 7), (72, 96)), ((3, 4), (64, 80)),
                                     ((40, 30), (41, 97))])
def test_resize_cubic_f64_equals_cv2(src, dst):
    g = np.random.default_rng(sum(src)).random((*src, 3))
    want = cv2.resize(g, (dst[1], dst[0]), interpolation=cv2.INTER_CUBIC)
    np.testing.assert_array_equal(tpr.resize_cubic_f64(g, dst[1], dst[0]),
                                  want)


def test_clip_equals_the_jax_tools(tmp_path):
    jpr.gen_sequence(str(tmp_path / "jax"), 4, 72, 96)
    tpr.gen_sequence(str(tmp_path / "port"), 4, 72, 96)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 4
    for name in names:
        want = cv2.imread(str(tmp_path / "jax" / name))[:, :, ::-1]
        got = imread(str(tmp_path / "port" / name))
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("protocol") / "run"
    summary = tpr.main(["--out", str(out), "--frames", "3", "--gop", "2",
                        "--rate-num", "1", "--size", "64x64",
                        "--device", "cpu"])
    return out, summary


def test_main_writes_the_log_and_streams(run):
    out, summary = run
    assert summary["frames_total"] == 3 and summary["aggregate_fps"] > 0
    with open(out / "summary.json") as f:
        assert json.load(f) == summary
    with open(out / "protocol_log.json") as f:
        log = json.load(f)
    rec = log["Synthetic"]["Synthetic_64x64_30"]["000"]
    assert rec["frame_type"] == [0, 1, 0]
    assert np.isfinite(rec["ave_all_frame_psnr"])
    bins = out / "bins" / "Synthetic_64x64_30" / "0"
    sizes = [os.path.getsize(bins / f"{i}.bin") for i in range(3)]
    assert min(sizes) > 0
    assert rec["ave_all_frame_bpp"] == pytest.approx(
        8 * sum(sizes) / (3 * 64 * 64), rel=1e-6)
    assert len(tpr.rd_lines(log)) == 1


def test_every_stream_decodes_to_the_encoders_recon(run):
    """The decode check runs on every call: fresh codecs decode each .bin
    to the harness's per-frame digest (an I-frame's decode, a P-frame's
    encoder recon); on the CPU no kernel launches."""
    out, summary = run
    assert summary["decoded_equal_frames"] == 3
    with open(out / "frames.json") as f:
        coded = json.load(f)
    assert [[f["type"] for f in rate] for rate in coded] == [[0, 1, 0]]
    assert len({f["recon_sha256"] for f in coded[0]}) == 3
    assert summary["launches_per_rate_point"] == [
        dict.fromkeys(coded[0][0]["launches"], 0)]
    assert set(summary["launches_per_frame"]) == {"i", "p"}


def test_a_corrupted_stream_fails_the_decode_check(run, tmp_path):
    """Frame 2 (an I-frame) replaced by frame 0's stream: a valid .bin
    that decodes to another picture, so the check exits naming it."""
    out, _ = run
    bins = tmp_path / "bins"
    shutil.copytree(out / "bins" / "Synthetic_64x64_30", bins)
    shutil.copy(bins / "0" / "0.bin", bins / "0" / "2.bin")
    with open(out / "frames.json") as f:
        coded = json.load(f)
    argv_tv = ["--test_config", str(out / "dataset_config.json"),
               "--rate_num", "1", "--write_stream", "True",
               "--output_path", str(tmp_path / "x.json"),
               "--device", "cpu"]
    decoded = tpr.decode_streams(argv_tv, str(bins), 3, 2, 1, 64, 64)
    assert decoded[0][:2] == [f["recon_sha256"] for f in coded[0][:2]]
    with pytest.raises(SystemExit, match=r"\(0, 2\)"):
        tpr.check_streams(decoded, coded)
