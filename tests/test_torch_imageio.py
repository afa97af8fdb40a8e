"""PyTorch port, image I/O and settings: the port's PNG codec against the
files PIL and OpenCV write, the port's OpenCV resizes against cv2, its
YAML subset against PyYAML, and the small host helpers against the JAX
package's; plus the rule that the port's modules import no JAX.

Tolerances: PNG pixels equal. INTER_AREA (f32, 0..255 values): atol 1e-4
(another f32 summation order, at most 4.6e-5 measured). INTER_LINEAR
uint8: within one level, at most 1 % of the pixels off (OpenCV rounds the
last lanes of a row in scalar code; 0.18 % measured). INTER_CUBIC uint8:
equal to cv2 with its optimizations off (cv2.setUseOptimized(False), the
reference C++ path); with them on (AVX2/IPP dispatch) within one level on
at most 10 % of the pixels (about 3-5 % measured).
"""

from __future__ import annotations

import os
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from tests.test_torch_warp_twopass import one_torch_thread  # noqa: F401
from vcm_ts_tpu.utils import common as j_common
from vcm_ts_tpu.utils.config import CfgNode as JCfgNode
from vcm_ts_tpu_torch.codec import png_io
from vcm_ts_tpu_torch.ops import cv_resize
from vcm_ts_tpu_torch.utils import common, config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _image(rng, h, w, c):
    """Smooth structure plus noise: PIL's and cv2's adaptive filtering pick
    several row filters on it."""
    base = np.linspace(0, 255, w)[None, :, None] * np.ones((h, 1, c))
    base[h // 3:2 * h // 3] = rng.integers(0, 256, (1, w, c))
    base[2 * h // 3:] += rng.normal(0, 30, (h - 2 * h // 3, w, c))
    return base.clip(0, 255).astype(np.uint8)


def _filters(path):
    data = open(path, "rb").read()
    chunks = dict(png_io._chunks(data))
    w, h = np.frombuffer(chunks[b"IHDR"][:8], ">u4")
    rows = zlib.decompress(b"".join(b for k, b in png_io._chunks(data)
                                    if k == b"IDAT"))
    return set(np.frombuffer(rows, np.uint8).reshape(h, -1)[:, 0].tolist())


def test_png_reads_pil_and_cv2_files(tmp_path):
    """Gray, RGB and RGBA files from PIL and RGB files from cv2 read pixel
    for pixel; between them they use every row filter but Average, which
    the port's own writer covers (next test)."""
    rng = np.random.default_rng(0)
    seen = set()
    for c, mode in ((1, "L"), (3, "RGB"), (4, "RGBA")):
        img = _image(rng, 37, 53, c)
        path = str(tmp_path / f"pil{c}.png")
        Image.fromarray(img[:, :, 0] if c == 1 else img, mode).save(path)
        assert np.array_equal(png_io.read_png(path), img)
        seen |= _filters(path)
    img = _image(rng, 41, 67, 3)
    path = str(tmp_path / "cv2.png")
    cv2.imwrite(path, img[:, :, ::-1])
    assert np.array_equal(png_io.imread(path), img)
    assert np.array_equal(png_io.imread(str(tmp_path / "pil1.png")),
                          np.repeat(png_io.read_png(
                              str(tmp_path / "pil1.png")), 3, 2))
    seen |= _filters(path)
    assert {0, 1, 2, 4} <= seen, seen


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_png_port_writer_each_filter(tmp_path, filter_type):
    """The port writes every filter type; PIL and the port read it back."""
    img = _image(np.random.default_rng(filter_type), 29, 31, 3)
    path = str(tmp_path / "x.png")
    png_io.write_png(path, img, filter_type=filter_type)
    assert _filters(path) == {filter_type}
    assert np.array_equal(np.asarray(Image.open(path)), img)
    assert np.array_equal(png_io.read_png(path), img)


def test_png_save_and_read_image_match_jax(tmp_path):
    """save_image / read_image / PNGReader as the JAX package's png_io."""
    from vcm_ts_tpu.codec import png_io as j_png

    x = np.random.default_rng(3).random((1, 20, 24, 3)).astype(np.float32)
    png_io.save_image(x, str(tmp_path / "im1.png"))
    j_png.save_image(x, str(tmp_path / "j.png"))
    assert np.array_equal(png_io.read_image(str(tmp_path / "im1.png")),
                          j_png.read_image(str(tmp_path / "j.png")))
    reader = png_io.PNGReader(str(tmp_path))
    assert np.array_equal(reader.read_one_frame(),
                          j_png.read_image(str(tmp_path / "j.png"))[0])
    assert reader.read_one_frame() is None


@pytest.mark.parametrize("src,dst", [
    ((192, 256), (115, 154)),   # MTCNN pyramid level, non-integer ratio
    ((64, 64), (32, 32)),       # integer ratio (OpenCV's fast path)
    ((100, 93), (24, 24)),      # a crop down to R-Net's input
    ((10, 13), (48, 48)),       # a small crop up to O-Net's input
    ((30, 12), (24, 24)),       # one axis shrinks, the other grows
])
def test_resize_area_matches_cv2(src, dst):
    img = (np.random.default_rng(sum(src)).random(src + (3,)) * 255).astype(
        np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    got = cv_resize.resize_area(torch.from_numpy(img), *dst).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_crop_resize_area_matches_cv2_per_crop():
    """Batched crops (1-indexed inclusive boxes, some empty, over more than
    one chunk) equal cv2 on each crop."""
    img = (np.random.default_rng(5).random((60, 80, 3)) * 255).astype(
        np.float32)
    boxes = np.array([[1, 1, 80, 60], [10, 5, 30, 40], [70, 50, 80, 60],
                      [5, 5, 4, 9]])
    # more boxes than one chunk of batched matmuls holds
    boxes = np.concatenate([boxes] * (cv_resize.CROP_CHUNK // 4 + 1))
    got = cv_resize.crop_resize_area(torch.from_numpy(img), boxes,
                                     24).numpy()
    for (x1, y1, x2, y2), g in zip(boxes, got):
        if x2 < x1:
            assert not g.any()
            continue
        want = cv2.resize(img[y1 - 1:y2, x1 - 1:x2], (24, 24),
                          interpolation=cv2.INTER_AREA)
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-4)


def _blurred(seed, h, w, c):
    img = (np.random.default_rng(seed).random((h, w, c)) * 255).astype(
        np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 0).reshape(h, w, c)


@pytest.mark.parametrize("src,dst", [
    ((192, 256), (240, 320)),    # the 256x192 letterbox to 320
    ((1088, 1920), (180, 320)),  # the 1080p letterbox
    ((100, 77), (37, 91)),
])
def test_resize_linear_u8_within_one_level(src, dst):
    img = _blurred(sum(src), *src, 3)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = cv_resize.resize_linear_u8(torch.from_numpy(img), *dst).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (
        diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("src,dst", [
    ((40, 130), (32, 104)),  # plate crops to the OCR height
    ((150, 540), (32, 115)),
    ((20, 60), (32, 96)),
])
def test_resize_cubic_u8_matches_cv2(src, dst):
    img = _blurred(sum(src), *src, 1)
    got = cv_resize.resize_cubic_u8(torch.from_numpy(img), *dst).numpy()[
        :, :, 0]
    try:
        cv2.setUseOptimized(False)
        exact = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_CUBIC)
    finally:
        cv2.setUseOptimized(True)
    assert np.array_equal(got, exact)
    fast = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_CUBIC)
    diff = np.abs(got.astype(int) - fast.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.10


E2E_SETTINGS = """
BASE_LAYER:
  DCVC_HEM:
    I_FRAME_WEIGHTS: 'ckpt/image.ckpt'
    P_FRAME_WEIGHTS: 'ckpt/video.ckpt'
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


@pytest.mark.parametrize("source", ["template", "e2e_learned"])
def test_yaml_subset_matches_pyyaml(source, tmp_path):
    """The settings files parse to PyYAML's tree; merged into the defaults
    they give the JAX CfgNode's tree; the port's dump reads back equal."""
    from vcm_ts_tpu.train.config import default_codec_settings as j_defaults

    if source == "template":
        path = os.path.join(REPO, "configs", "codec_settings.yaml.template")
        text = open(path).read()
    else:
        text = E2E_SETTINGS
        path = str(tmp_path / "s.yaml")
        open(path, "w").write(text)
    assert config.load_yaml(text) == yaml.safe_load(text)
    port = config.default_codec_settings()
    port.merge_from_file(path)
    jax_cfg = j_defaults()
    jax_cfg.merge_from_file(path)
    assert port.to_dict() == jax_cfg.to_dict()
    assert yaml.safe_load(str(port)) == port.to_dict()


def test_yaml_scalars_and_errors():
    text = ("A: 1e-5\nB: 1.0e-5\nC: yes\nD: ~\nE: 'it''s'\nF: \"q\"\n"
            "G: -3\nH: [1, 'x', 2.5]\nI: 0x10\nJ: .inf\n")
    assert config.load_yaml(text) == yaml.safe_load(text)
    tree = {"K": {"F": 1e-05, "S": "a'b", "B": False, "N": None,
                  "L": [1, "x"]}}
    assert yaml.safe_load(config.dump_yaml(tree)) == tree
    for bad in ("A:\n  - 1\n", "A: &x 1\n", "A: |\n  text\n"):
        with pytest.raises(ValueError):
            config.load_yaml(bad)
    node = config.CfgNode({"A": {"B": 1}})
    node.merge_from_list(["A.B", "3"])
    assert node.A.B == 3
    j_node = JCfgNode({"A": {"B": 1}})
    j_node.merge_from_list(["A.B", "3"])
    assert node.to_dict() == j_node.to_dict()
    node.freeze()
    with pytest.raises(AttributeError):
        node.A.B = 4


@pytest.mark.parametrize("v", ["yes", "No", "1", "f", True, "maybe"])
def test_str2bool_matches_jax(v):
    def call(fn):
        try:
            return fn(v)
        except Exception as e:  # both raise the same type
            return type(e)

    assert call(common.str2bool) == call(j_common.str2bool)


def test_interpolate_log_matches_jax():
    for lo, hi, n in ((0.5, 1.2, 4), (0.01, 655.0, 6)):
        np.testing.assert_array_equal(common.interpolate_log(lo, hi, n),
                                      j_common.interpolate_log(lo, hi, n))


NEW_MODULES = (
    "vcm_ts_tpu_torch.codec.vcm_pipeline", "vcm_ts_tpu_torch.codec.png_io",
    "vcm_ts_tpu_torch.ops.cv_resize", "vcm_ts_tpu_torch.ops.msssim",
    "vcm_ts_tpu_torch.train.yolo_v8", "vcm_ts_tpu_torch.eval.yolo_native",
    "vcm_ts_tpu_torch.eval.mtcnn_native", "vcm_ts_tpu_torch.eval.ocr_native",
    "vcm_ts_tpu_torch.eval.text_metrics",
    "vcm_ts_tpu_torch.eval.detection_metrics",
    "vcm_ts_tpu_torch.eval.bd_metrics", "vcm_ts_tpu_torch.eval.detector",
    "vcm_ts_tpu_torch.utils.config", "vcm_ts_tpu_torch.utils.common",
    "vcm_ts_tpu_torch.utils.logger", "vcm_ts_tpu_torch.utils.video",
    "vcm_ts_tpu_torch.utils.weights", "vcm_ts_tpu_torch.video_coder")


def test_new_modules_import_without_jax():
    """Every module of this slice imports with jax, flax, the JAX package
    and tools/ blocked."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'vcm_ts_tpu', 'tools'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {NEW_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
