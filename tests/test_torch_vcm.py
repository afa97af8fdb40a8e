"""PyTorch port, the VCM pipeline against the JAX package's on the CPU.

One MJPG clip (2 frames, 192x128, a rendered plate and face moving 2 px,
as tests/test_vcm_e2e_learned.py builds it) and one pair of .pth
checkpoints (the port's seeded damped IntraNoAR and DMC, with decreasing
q-scale anchors) go through:
- the JAX side: video_coder.py's sequence of vcm_pipeline calls, run in
  this process (the root CLI as a subprocess spends minutes in eager flax
  inits on a CPU), with the JAX detectors on the shipped .npz;
- the port side: `python -m vcm_ts_tpu_torch.video_coder --device cpu`'s
  main() on the same settings file.

Held: the same file layout; byte-identical base-layer and enhancement
.bin files (the damped control); equal uint16 box pickles; the decoded
base frames, residuals, decoded residuals and fused frames within one
level (the recons' floats come from two conv stacks, so a value that
rounds at .5 may land one level apart; measured: one pixel of the first
decoded base frame and so of its fused frame, the rest equal); PSNR
within 0.01 dB, bpp within 1e-6.
"""

from __future__ import annotations

import json
import os
import pickle
import sys
from glob import glob

import cv2
import jax
import numpy as np
import pytest
import torch

from tests.test_torch_detectors import jax_mtcnn, jax_yolo, sprite_frame
from tests.test_torch_warp_twopass import one_torch_thread  # noqa: F401
from vcm_ts_tpu.codec import vcm_pipeline as j_vp
from vcm_ts_tpu.models.dmc import DMC as JDMC
from vcm_ts_tpu.models.intra import IntraNoAR as JIntraNoAR
from vcm_ts_tpu.train.config import default_codec_settings as j_settings
from vcm_ts_tpu.utils import weight_import as j_wi
from vcm_ts_tpu_torch import video_coder
from vcm_ts_tpu_torch.codec import vcm_pipeline as vp
from vcm_ts_tpu_torch.codec.png_io import imread
from vcm_ts_tpu_torch.eval import detector as t_detector
from vcm_ts_tpu_torch.utils import weights
from vcm_ts_tpu_torch.utils.weights import make_dmc, make_intra

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 192, 128
Q_ANCHORS = (1.2, 0.9, 0.7, 0.5)
SETTINGS = """
BASE_LAYER:
  DCVC_HEM:
    I_FRAME_WEIGHTS: '{i}'
    P_FRAME_WEIGHTS: '{p}'
    GOP: 2
    RATE_COUNT: 4
    QUALITY: 1
    WRITE_STREAM: True
ENHANCEMENT_LAYER:
  CODEC: intra
  LEARNED:
    QUALITY: 3
    RATE_COUNT: 4
  DETECTORS:
    FACES:
      ENABLE: True
      PROB: 0.7
      PADDING: 2
    LIPLATES:
      ENABLE: True
      PROB: 0.5
      PADDING: 2
"""


def _save_pth(model, path):
    sd = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    for k in ("q_scale", "y_q_scale", "mv_y_q_scale"):
        if k in sd:
            sd[k] = torch.tensor(Q_ANCHORS).reshape(-1, 1, 1, 1)
    torch.save(sd, path)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    root = tmp_path_factory.mktemp("vcm")
    img, _, _ = sprite_frame(3, (W, H))
    video = str(root / "in.avi")
    wtr = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10, (W, H))
    for t in range(2):
        wtr.write(cv2.cvtColor(np.roll(img, 2 * t, axis=1),
                               cv2.COLOR_RGB2BGR))
    wtr.release()
    ckpt = {"i": str(root / "image.pth"), "p": str(root / "video.pth")}
    _save_pth(make_intra("cpu"), ckpt["i"])
    _save_pth(make_dmc("cpu"), ckpt["p"])
    settings = root / "codec_settings.yaml"
    settings.write_text(SETTINGS.format(**ckpt))
    return root, video, ckpt, str(settings)


def _zeros_init(init):
    """A flax init that returns zeros of the init's tree (no eager init;
    the importer then fills every leaf from the .pth)."""
    def fake(self, rng, *a, **kw):
        shapes = jax.eval_shape(lambda: init(self, rng, *a, **kw))
        return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      shapes)
    return fake


@pytest.fixture(scope="module")
def jax_root(clip):
    """video_coder.py's calls on the JAX package (ffmpeg steps skipped,
    as the root CLI skips them without ffmpeg)."""
    root, video, ckpt, settings = clip
    out = str(root / "jax")
    cfg = j_settings()
    cfg.merge_from_file(settings)
    cfg.freeze()
    os.makedirs(os.path.join(out, j_vp.PATHS_INFO))
    with open(os.path.join(out, j_vp.PATHS_INFO, "codec_settings.yaml"),
              "w") as f:
        f.write(str(cfg))
    lp_det, fc_det = jax_yolo(os.path.join(REPO, "pretrained",
                                           "yolov8-lp.npz")), \
        jax_mtcnn(os.path.join(REPO, "pretrained", "mtcnn.npz"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JDMC, "init", _zeros_init(JDMC.init))
        mp.setattr(JIntraNoAR, "init", _zeros_init(JIntraNoAR.init))
        j = os.path.join
        j_vp.video_to_frames(video, out, j_vp.PATHS_ARTIFACTS_SOURCE_FRAMES)
        j_vp.encode_decode_dcvc(
            j(out, j_vp.PATHS_ARTIFACTS_SOURCE_FRAMES), ckpt["i"], ckpt["p"],
            anchor_num=4, gop=2, rate_count=4, quality=1, write_stream=True,
            out_frames_dir=j(out, j_vp.PATHS_ARTIFACTS_DCVC_HEM),
            out_bins_dir=j(out, j_vp.PATHS_ENCODED_DIR, "dcvc_hem_bins"))
        j_vp.detect_rois(out, "liplates", prob=0.5, padding=2,
                         detector=lambda f: lp_det.detect(f, conf=0.25)[:2])
        j_vp.detect_rois(out, "faces", prob=0.7, padding=2,
                         detector=fc_det.detect)
        j_vp.compute_residuals(out, True, True,
                               j(out, j_vp.PATHS_ARTIFACTS_RESIDUALS))
        j_vp.encode_residuals_learned(
            out, ckpt["i"], 3, j(out, j_vp.PATHS_ARTIFACTS_RESIDUALS_ENCODED),
            rate_count=4)
        j_vp.calc_bitrate_metrics(out, video, gop=2)
        j_vp.fuse_layers(out, faces_padding=2, liplates_padding=2)
        j_vp.calc_visual_metrics(out, video, liplates_padding=2,
                                 faces_padding=2)
    return out


@pytest.fixture(scope="module")
def port_root(clip):
    root, video, _, settings = clip
    out = str(root / "port")
    video_coder.main(["--video-path", video, "--settings-file", settings,
                      "--result-root", out, "--device", "cpu"])
    return out


def _files(root):
    return sorted(os.path.relpath(p, root)
                  for p in glob(os.path.join(root, "**", "*"), recursive=True)
                  if os.path.isfile(p))


def _read(root, rel):
    with open(os.path.join(root, rel), "rb") as f:
        return f.read()


def test_cli_writes_the_jax_layout(jax_root, port_root):
    files = _files(port_root)
    assert files == _files(jax_root)
    for rel in ("info/codec_settings.yaml", "info/psnr_metrics.txt",
                "info/bitrate_metrics.txt", "info/quality.json"):
        assert rel in files
    assert len([f for f in files if f.endswith(".bin")]) == 4


def test_settings_dump_equal(jax_root, port_root):
    import yaml

    rel = "info/codec_settings.yaml"
    assert (yaml.safe_load(_read(port_root, rel))
            == yaml.safe_load(_read(jax_root, rel)))


@pytest.mark.parametrize("layer", ["dcvc_hem_bins", "enhancement_bins"])
def test_streams_byte_identical(jax_root, port_root, layer):
    rels = [f for f in _files(jax_root) if f.startswith(f"encoded/{layer}/")]
    assert len(rels) == 2
    for rel in rels:
        assert _read(port_root, rel) == _read(jax_root, rel), rel


@pytest.mark.parametrize("kind", ["liplates", "faces"])
def test_coords_equal(jax_root, port_root, kind):
    rels = [f for f in _files(jax_root)
            if f.startswith(f"encoded/{kind}_coords/")]
    assert len(rels) == 2
    found = 0
    for rel in rels:
        a = pickle.loads(_read(port_root, rel))
        b = pickle.loads(_read(jax_root, rel))
        assert a.dtype == b.dtype == np.uint16
        np.testing.assert_array_equal(a, b)
        found += len(a.reshape(-1, 4))
    assert found >= 2  # one per frame at least


@pytest.mark.parametrize("folder", [
    vp.PATHS_ARTIFACTS_SOURCE_FRAMES, vp.PATHS_ARTIFACTS_DCVC_HEM,
    vp.PATHS_ARTIFACTS_RESIDUALS, vp.PATHS_ARTIFACTS_RESIDUALS_ENCODED,
    vp.PATHS_ARTIFACTS_RESULT])
def test_frames_within_one_level(jax_root, port_root, folder):
    rels = [f for f in _files(jax_root) if f.startswith(folder + "/")]
    assert len(rels) == 2
    for rel in rels:
        a = imread(os.path.join(port_root, rel)).astype(int)
        b = imread(os.path.join(jax_root, rel)).astype(int)
        assert np.abs(a - b).max() <= 1, rel
    if folder == vp.PATHS_ARTIFACTS_RESIDUALS:
        assert max(imread(os.path.join(port_root, r)).max()
                   for r in rels) > 0  # the ROIs carry a residual


def _metrics(root, name):
    out = {}
    for line in open(os.path.join(root, "info", name)):
        if line.startswith("Results for"):
            continue
        k, v = line.rsplit(":", 1)
        out[k] = float(v)
    return out


def test_metrics_match(jax_root, port_root):
    a, b = (_metrics(r, "psnr_metrics.txt") for r in (port_root, jax_root))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == pytest.approx(b[k], abs=0.01), k
    a, b = (_metrics(r, "bitrate_metrics.txt") for r in (port_root,
                                                         jax_root))
    for k in a:
        assert a[k] == pytest.approx(b[k], abs=1e-6), k
    assert (json.loads(_read(port_root, "info/quality.json"))
            == json.loads(_read(jax_root, "info/quality.json")))


@pytest.mark.parametrize("w,h,border", [(30, 20, 10), (5, 7, 10),
                                         (40, 41, 3), (13, 9, 0), (1, 1, 4)])
def test_gradient_mask_on_device_equals_numpy(w, h, border):
    """fuse_layers' device mask equals create_gradient_mask (the JAX
    package's numpy loop), small boxes and no border included."""
    np.testing.assert_array_equal(
        vp.gradient_mask(w, h, border, "cpu").numpy(),
        vp.create_gradient_mask(w, h, border))
    np.testing.assert_array_equal(vp.create_gradient_mask(w, h, border),
                                  j_vp.create_gradient_mask(w, h, border))


def test_q_scales_and_codec_weights_load_like_jax(clip):
    _, _, ckpt, _ = clip
    for a, b in zip(weights.get_q_scales_from_ckpt(ckpt["p"]),
                    j_wi.get_q_scales_from_ckpt(ckpt["p"])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        weights.get_i_frame_q_scales_from_ckpt(ckpt["i"]),
        j_wi.get_i_frame_q_scales_from_ckpt(ckpt["i"]))
    np.testing.assert_allclose(vp._q_ladder(np.array(Q_ANCHORS), 4),
                               j_vp._q_ladder(np.array(Q_ANCHORS), 4))
    model, y_q, _ = vp.load_video_model(ckpt["p"], device="cpu")
    np.testing.assert_array_equal(y_q, np.array(Q_ANCHORS, np.float32))
    ref = make_dmc("cpu")
    for (k, v), (k2, v2) in zip(model.state_dict().items(),
                                ref.state_dict().items()):
        assert k == k2
        if "q_scale" not in k:
            assert torch.equal(v, v2), k


def test_framework_checkpoints_wait_for_training(tmp_path):
    with pytest.raises(NotImplementedError, match="training"):
        vp.load_intra_codec(str(tmp_path / "image.ckpt"), device="cpu")
    with pytest.raises(ValueError):
        vp.encode_decode_dcvc("x", "", "y", 4, 2, 4, 1, True, "a", "b",
                              device="cpu")


def test_missing_tools_raise(monkeypatch, tmp_path):
    """No silent fallback: without ffmpeg, cv2, a detector's weights or a
    card, the entry points raise with what is missing."""
    monkeypatch.setattr(vp.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        vp.encode_folder_crf("in%05d.png", str(tmp_path / "x.h265"), 23)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="OpenCV"):
        vp.video_to_frames("in.avi", str(tmp_path), "frames")
    with pytest.raises(RuntimeError, match="OpenCV"):
        vp.calc_bitrate_metrics(str(tmp_path), "in.avi", 2)
    monkeypatch.setattr(vp, "PRETRAINED", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="mtcnn.npz"):
        vp.build_detector("faces", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            vp.detect_rois(str(tmp_path), "faces", device="cuda")


def test_eval_detector_backends(monkeypatch, tmp_path):
    class Cfg:
        class SOLVER:
            PL_MODEL = "resnet"

    with pytest.raises(FileNotFoundError, match="fasterrcnn"):
        t_detector.build_eval_detector(Cfg, device="cpu")
    Cfg.SOLVER.PL_MODEL = "yolo"
    monkeypatch.setattr(weights, "PRETRAINED", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="yolov8m.npz"):
        t_detector.build_eval_detector(Cfg, device="cpu")
    os.symlink(os.path.join(REPO, "pretrained", "yolov8-lp.npz"),
               str(tmp_path / "yolov8m.npz"))
    adapter = t_detector.build_eval_detector(Cfg, device="cpu")
    out = adapter(np.zeros((1, 64, 96, 3), np.float32))
    assert set(out) == {"boxes", "labels", "scores"}
