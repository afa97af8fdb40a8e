"""PyTorch port, the perceptual losses (train/losses.py, the YOLO loss of
train/yolo_v8.py) against the JAX package on the CPU, and the trainer with
a perceptual stage.

Weights: the JAX modules' flax trees (shapes from jax.eval_shape, no
init) filled from a numpy seed, BatchNorm statistics included, carried
into the port with utils/weights.state_dict_from_flax (the tests'
load_flax, strict). Inputs are numpy draws; the decoded frame has pixels
at exactly 0 and 1, where `jnp.clip`'s gradient is 0.5.

Tolerances (f32): the ResNet-50 taps and the FPN outputs (2x64x64) within
1e-4 of the reference's largest magnitude; each loss's value rtol 1e-4
and its gradient to the decoded frame within 1e-3 of the largest
gradient (XLA's and oneDNN's convs sum in other orders; fifty layers
carry that to a few 1e-6; float64 on both sides for the gradients, see
test_loss_and_gradient_match_jax). The ResNet loss's value and gradient
are in tests/test_torch_rcnn.py; get_perceptual_loss on a
torchvision-layout .pth and a train step with the perceptual loss in
tests/test_torch_perceptual_step.py.
"""

from __future__ import annotations

import copy
import functools
import json
import logging
import math
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_warp_twopass import one_torch_thread  # noqa: F401
from tests.torch_port_util import load_flax, nchw, nhwc
from vcm_ts_tpu.train import losses as JL
from vcm_ts_tpu.train.yolo_v8 import YOLOV8PerceptualLoss as JYOLOLoss
from vcm_ts_tpu_torch import trainer
from vcm_ts_tpu_torch.codec.png_io import imwrite
from vcm_ts_tpu_torch.train import losses as L
from vcm_ts_tpu_torch.train import train_loop
from vcm_ts_tpu_torch.train.tensorboard import MetricWriter
from vcm_ts_tpu_torch.train.yolo_v8 import (YOLOV8PerceptualLoss,
                                            load_yolo_backbone)
from vcm_ts_tpu_torch.utils.config import default_training_cfg

RESNET_TAPS = ("1", "2", "3", "4", "5")
FPN_TAPS = ("0", "1", "2", "3", "pool")
YOLO_TAPS = ("1", "2", "3", "4", "5", "3_deep", "4_deep", "5_deep")
YOLO_SCALE = dict(width=0.125, depth=0.34)  # tests/test_perceptual_loss.py


def seeded_tree(init_fn, seed):
    """A flax parameter tree shaped like init_fn's, filled from a numpy
    seed: kernels N(0, 1 / fan_in), BatchNorm weight 1 + N(0, 0.1^2),
    running mean N(0, 0.1^2), running variance U(0.5, 1.5), biases
    N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.standard_normal(s.shape) / math.sqrt(
                np.prod(s.shape[:-1]))
        elif name == "running_var":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name == "weight":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            v = 0.1 * rng.standard_normal(s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init_fn))


@pytest.fixture(scope="module")
def nets():
    """{kind: (JAX module, its params, the port module)} for resnet, fpn and
    the narrow yolo; resnet's body is fpn's."""
    x0 = jnp.zeros((1, 64, 64, 3))
    jfpn = JL.FasterRCNNFPNPerceptualLoss()
    fpn_params = seeded_tree(
        lambda: jfpn.init(jax.random.PRNGKey(0), x0, x0), 0)
    res_params = {"params": {"body": fpn_params["params"]["body"]}}
    jyolo = JYOLOLoss(**YOLO_SCALE)
    yolo_params = seeded_tree(
        lambda: jyolo.init(jax.random.PRNGKey(0), x0, x0), 1)
    return {
        "resnet": (JL.FasterRCNNResNetPerceptualLoss(), res_params,
                   load_flax(L.FasterRCNNResNetPerceptualLoss(),
                             res_params)),
        "fpn": (jfpn, fpn_params,
                load_flax(L.FasterRCNNFPNPerceptualLoss(), fpn_params)),
        "yolo": (jyolo, yolo_params,
                 load_flax(YOLOV8PerceptualLoss(**YOLO_SCALE), yolo_params)),
    }


def _frames(seed, n=2, h=60, w=60):
    """(decoded, target) NHWC; decoded holds, on a sparse lattice of
    isolated pixels, values of exactly 0 and 1 and values outside [0, 1].
    Not areas of them: the clip turns an area into a constant patch, whose
    ties in the ResNet stem's max pool the stacks break differently (XLA's
    window reduction order, torch's first index; both valid
    subgradients)."""
    rng = np.random.default_rng(seed)
    target = rng.random((n, h, w, 3)).astype(np.float32)
    decoded = np.clip(target + 0.05 * rng.standard_normal(target.shape),
                      0.02, 0.98).astype(np.float32)
    i, j = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    lattice = (i + 3 * j) % 17
    for r, v in ((0, 0.0), (5, 1.0), (9, -0.3), (13, 1.3)):
        decoded[:, lattice == r] = v
    return decoded, target


def _close_to_max(got, want, rel, name=""):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.max(np.abs(want))),
                               err_msg=name)


def test_resnet_body_and_fpn_match_jax(nets):
    """ResNet50Body's five taps and the FPN's five outputs on 2x64x64."""
    _, params, port = nets["fpn"]
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(
        np.float32)

    @jax.jit
    def ref(x):
        p = params["params"]
        f = JL.ResNet50Body().apply({"params": p["body"]}, x)
        return f, JL.FPN().apply({"params": p["fpn"]},
                                 {k: f[k] for k in ("2", "3", "4", "5")})

    jf, jp = ref(jnp.asarray(x))
    with torch.no_grad():
        f = port.body(nchw(x).contiguous())
        p = port.fpn({k: f[k] for k in ("2", "3", "4", "5")})
    assert set(f) == set(RESNET_TAPS) and set(p) == set(FPN_TAPS)
    for k in RESNET_TAPS:
        _close_to_max(nhwc(f[k]), np.asarray(jf[k]), 1e-4, f"body {k}")
    for k in FPN_TAPS:
        _close_to_max(nhwc(p[k]), np.asarray(jp[k]), 1e-4, f"fpn {k}")


@pytest.mark.parametrize("kind", ["fpn", "yolo", "clip"])
def test_loss_and_gradient_match_jax(nets, kind):
    """Each loss's per-row value (f32, 2x60x60) and d loss / d decoded
    against jax.grad (the YOLO loss pads to 64); "clip": the clip alone,
    whose gradient at a bound is 0.5 in both.

    The gradients are compared in float64 on both sides, on the first row
    (the port's module cast with .double(), JAX under jax.enable_x64): in
    f32 a ReLU or max-pool input that lies within rounding of a kink
    takes the other branch, in both stacks alike (measured on these
    frames: each f32 stack's gradient off float64's by 0.64 % (ResNet) and
    5.5 % (FPN) of its largest at a few pixels, the two float64 gradients
    within 6.5e-8 and 4.4e-7). The values stay f32, continuous at a kink.
    The ResNet loss's case is in tests/test_torch_rcnn.py (time
    budget)."""
    decoded, target = _frames(3)
    if kind == "clip":
        v = np.array([-1.0, 0.0, 0.25, 1.0, 2.0], np.float32)
        want = jax.grad(lambda a: jnp.clip(a, 0, 1).sum())(jnp.asarray(v))
        t = torch.from_numpy(v).requires_grad_()
        L.jclip01(t).sum().backward()
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
        return
    jmodel, params, port = nets[kind]
    taps = {"resnet": RESNET_TAPS, "fpn": FPN_TAPS, "yolo": YOLO_TAPS}[kind]

    def jloss(d, tg):
        if kind == "yolo":
            return jmodel.apply(params, tg, d, feature_layers=taps)
        return jmodel.apply(params, d, tg, feature_layers=taps)

    def loss(model, d, tg):
        return model(tg, d) if kind == "yolo" else model(d, tg)

    jvals = jax.jit(jloss)(jnp.asarray(decoded), jnp.asarray(target))
    with torch.no_grad():
        vals = loss(port, nchw(decoded).contiguous(),
                    nchw(target).contiguous())
    assert vals.shape == (2,)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-4)

    check_gradient_f64(jloss, loss, port, decoded[:1], target[:1], kind)


def _jax_grad_f64(jloss, decoded, target):
    with jax.enable_x64(True):
        return np.asarray(jax.jit(jax.grad(lambda d, tg: jloss(d, tg).sum()))(
            jnp.asarray(decoded, jnp.float64),
            jnp.asarray(target, jnp.float64)))


def check_gradient_f64(jloss, loss, port, decoded, target, name):
    """d loss / d decoded of both stacks in float64: within 1e-3 of the
    largest. XLA compiles and runs the JAX gradient outside the
    interpreter lock, in a thread beside the port's backward."""
    with ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(_jax_grad_f64, jloss, decoded, target)
        d = nchw(decoded).double().contiguous().requires_grad_()
        loss(copy.deepcopy(port).double(), d,
             nchw(target).double().contiguous()).sum().backward()
        jg = jax_run.result()
    assert jg.dtype == np.float64
    _close_to_max(nhwc(d.grad), jg, 1e-3, f"{name} d decoded")
    assert float(d.grad.abs().max()) > 0


def _rcnn_pth(port_fpn_loss, path):
    """A torchvision-layout checkpoint holding the loss's body and FPN as
    backbone.*, with BatchNorm's num_batches_tracked and an RPN tensor
    beside them, as the real file has."""
    sd = {"backbone." + k: v.clone() for k, v in
          port_fpn_loss.state_dict().items()}
    for k in list(sd):
        if k.endswith(".running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0)
    sd["rpn.head.cls_logits.bias"] = torch.zeros(3)
    torch.save(sd, path)


def test_loaders_raise_and_factory_falls_back(nets, tmp_path, caplog):
    """A load_* function named a missing file raises and names it; without
    its weights file a factory warns, names the file and uses a seeded
    init (the same seed gives the same loss); an unknown kind raises; the
    YOLO backbone loads from an .npz with ultralytics names (the head
    dropped) strict."""
    missing = str(tmp_path / "nope.pth")
    with pytest.raises(FileNotFoundError, match="nope.pth"):
        L.load_rcnn_backbone(L.FasterRCNNResNetPerceptualLoss(), missing)
    with pytest.raises(FileNotFoundError, match="nope.npz"):
        load_yolo_backbone(YOLOV8PerceptualLoss(),
                           str(tmp_path / "nope.npz"))
    cfg = default_training_cfg()
    cfg.SOLVER.PL_MODEL = "yolo"
    decoded, target = _frames(5, h=32, w=32)
    vals = []
    for _ in range(2):
        with caplog.at_level(logging.WARNING, logger="CORE"):
            caplog.clear()
            pl = L.get_perceptual_loss(cfg, "cpu", seed=3,
                                       path=str(tmp_path / "yolov8m.pt"))
        assert "yolov8m.npz" in caplog.text
        with torch.no_grad():
            vals.append(pl(torch.from_numpy(target),
                           torch.from_numpy(decoded)).numpy())
    np.testing.assert_array_equal(vals[0], vals[1])
    assert np.all(np.isfinite(vals[0])) and np.all(vals[0] > 0)
    cfg.SOLVER.PL_MODEL = "vgg"
    with pytest.raises(ValueError, match="vgg"):
        L.get_perceptual_loss(cfg, "cpu")

    port = nets["yolo"][2]
    npz = str(tmp_path / "tiny.npz")
    arrays = {"model." + k: v.numpy() for k, v in port.model.state_dict(
        ).items()}
    arrays["model.22.cv2.0.0.conv.weight"] = np.zeros((1, 1, 1, 1),
                                                      np.float32)
    arrays["__meta__"] = np.array('{"nc": 80}')
    np.savez(npz, **arrays)
    fresh = load_yolo_backbone(YOLOV8PerceptualLoss(**YOLO_SCALE), npz)
    for k, v in port.model.state_dict().items():
        torch.testing.assert_close(fresh.model.state_dict()[k], v, rtol=0,
                                   atol=0)


def test_trainer_runs_a_perceptual_stage(tmp_path, monkeypatch):
    """python -m vcm_ts_tpu_torch.trainer's main with one single-frame
    stage whose perceptual field is true (no weights file: the seeded
    ResNet-50): a finite loss and p_dist > 0 in its log."""
    for s in range(2):
        d = tmp_path / "data" / "g" / f"seq{s}" / "raw"
        os.makedirs(d)
        base = np.random.default_rng(s).random((8, 8, 3))
        for t in range(2):
            img = np.kron(np.roll(base, t, axis=1), np.ones((8, 8, 1)))
            imwrite(str(d / f"{t:05d}.png"), (img * 255).astype(np.uint8))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"""
MODEL:
  CHANNELS: [16, 16, 24]
DATASET:
  TYPE: SequenceDataset
  TRAIN_ROOT_DIRS: ['{tmp_path / "data"}']
  TRAIN_SUBDIR_LISTS: ['']
  SEQUENCE_LENGTH: 2
INPUT:
  IMAGE_SIZE: [64, 64]
SOLVER:
  LAMBDAS: [85, 170]
  STAGES:
    - ['1', 'all', 'single', 'rec', 'all', '0.0001', '1', 'true']
OUTPUT_DIR: '{tmp_path}/out'
""")
    monkeypatch.setattr(train_loop, "MetricWriter", functools.partial(
        MetricWriter, enable_tb=False))
    rec = trainer.main(["--device", "cpu", "--config-file", str(cfg)])
    assert [e["stage"] for e in rec["epochs"]] == [0]
    assert rec["iterations"] and all(
        np.all(np.isfinite(it["loss"])) for it in rec["iterations"])
    lines = [json.loads(line) for line in
             (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    p_dist = [r["value"] for r in lines
              if r["tag"].startswith("train/p_dist/")]
    assert p_dist and min(p_dist) > 0
    assert os.path.exists(tmp_path / "out" / "model_epoch_000.pt")
    saved = torch.load(tmp_path / "out" / "model_epoch_000.pt",
                       weights_only=True)["params"]
    assert not any(k.startswith(("body.", "model.")) for k in saved)
