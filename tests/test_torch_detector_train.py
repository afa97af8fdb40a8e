"""The port's detector and OCR trainers against the JAX package's on the
CPU (tools/train_plate_ocr.py, train_plate_detector.py,
train_face_detector.py).

The same numpy inputs from a seed go through both sides at small sizes
(YOLOv8-n at 64x64 with batch 2, MTCNN at 12/24/48 with 8 crops, the OCR
at width 64 with batch 4), one torch thread, the JAX side computing in a
thread beside the port's. The JAX parameters come from jax.eval_shape
templates filled from a seed (no eager flax init) and cross into the
port through the JAX tools' own exporters. Tolerances: the CTC loss and
its gradient rtol 1e-5 (of the largest value); each trainer's loss rtol
1e-5 and every gradient within 1e-4 of its tensor's largest; the
optimizer and schedule rtol 1e-6 over 5 steps; build_targets exact;
exported weights through the JAX loaders within
tests/test_torch_detectors.py's tolerances (YOLO boxes 1e-3 px and scores
1e-5, MTCNN nets 1e-5, OCR logits 1e-3); the synthesis primitives against
cv2 where it is installed: the filled rectangle exact, INTER_AREA within
one level, line, ellipse and circle masks at IoU >= 0.9.
"""

from __future__ import annotations

import functools
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_detectors import jax_mtcnn, jax_yolo
from tests.test_torch_warp_twopass import one_torch_thread  # noqa: F401
from vcm_ts_tpu.eval import mtcnn_native as j_mtcnn
from vcm_ts_tpu.eval import ocr_native as j_ocr
from vcm_ts_tpu.eval import yolo_native as j_yolo
from vcm_ts_tpu.utils.weight_export import flax_to_torch_state_dict
from vcm_ts_tpu_torch import train_face_detector as tfd
from vcm_ts_tpu_torch import train_plate_detector as tpd
from vcm_ts_tpu_torch import train_plate_ocr as tpo
from vcm_ts_tpu_torch.data import synth
from vcm_ts_tpu_torch.eval.mtcnn_native import MTCNNNativeDetector
from vcm_ts_tpu_torch.eval.ocr_native import CHARSET, PlateOCRNative
from vcm_ts_tpu_torch.eval.yolo_native import YOLOv8NativeDetector
from vcm_ts_tpu_torch.train import ctc
from vcm_ts_tpu_torch.train.losses import train_batch_norm_tensors
from vcm_ts_tpu_torch.train.optimizer import (AdamW,
                                              warmup_cosine_decay_schedule)
from vcm_ts_tpu_torch.utils.weights import ocr_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import train_face_detector as j_tfd  # noqa: E402
from tools import train_plate_detector as j_tpd  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def beside(jax_fn, port_fn):
    """(jax_fn(), port_fn()) with the JAX side in a thread alongside."""
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(jax_fn)
        got = port_fn()
        return fut.result(), got


def seeded_tree(template, seed):
    """A flax params template filled from a seed: kernels ~ N(0, 1/fan_in),
    BatchNorm scales and variances in [0.5, 1.5], other leaves N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)
        if name in ("running_var", "weight") and len(shape) == 1 and \
                any("bn" in str(p.key) for p in path):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, template)


def template(init_fn):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  jax.eval_shape(init_fn))


def assert_grads(got: dict, want: dict, rtol=1e-4):
    """Every gradient within rtol of its tensor's largest."""
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        w = np.asarray(want[k], np.float64)
        g = np.asarray(got[k], np.float64)
        assert g.shape == w.shape, k
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(g - w).max() <= rtol * scale, (
            k, np.abs(g - w).max() / scale)


# ------------------------------------------------------------------- CTC
def ctc_case(seed, b, t):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (b, t, 37)).astype(np.float32)
    labels = np.zeros((b, 9), np.int32)
    pad = np.ones((b, 9), np.float32)
    for i in range(b):
        n = int(rng.integers(1, 10))
        row = rng.integers(1, 37, n)
        if n >= 3:  # repeated labels: a blank must separate them
            row[1] = row[0]
            row[-1] = row[-2]
        labels[i, :n], pad[i, :n] = row, 0
    return logits, labels, pad


@functools.lru_cache(maxsize=None)
def optax_ctc64(seed, b, t):
    """optax.ctc_loss and its gradient in float64 (jax's x64 mode)."""
    logits, labels, pad = ctc_case(seed, b, t)
    with jax.enable_x64(True):
        def f(lg):
            return optax.ctc_loss(lg, jnp.zeros((b, t), jnp.float64),
                                  labels, jnp.asarray(pad, jnp.float64))

        want = np.asarray(jax.jit(f)(jnp.asarray(logits, jnp.float64)))
        want_g = np.asarray(jax.jit(jax.grad(lambda lg: f(lg).sum()))(
            jnp.asarray(logits, jnp.float64)))
    return want, want_g


@pytest.mark.parametrize("route", ["plain", "fb"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed,b,t", [(0, 5, 16), (1, 4, 40), (2, 8, 24)])
def test_ctc_matches_optax(seed, b, t, dtype, route):
    """Against optax.ctc_loss in float64 (jax's x64 mode), the port's two
    routes (the plain version, which ctc_loss takes on the CPU, and the
    card's forward-backward route) in f32 and in f64. In f32 XLA's own CPU
    result lies 1.1-1.5e-5 (of the largest) from its float64 gradient on
    these cases, the port's plain version 2-5e-6, so the f32 reference
    would measure XLA's rounding, not the port's."""
    logits, labels, pad = ctc_case(seed, b, t)
    want, want_g = optax_ctc64(seed, b, t)
    x = torch.tensor(logits, dtype=dtype, requires_grad=True)
    fn = ctc.ctc_loss if route == "plain" else ctc.ctc_loss_fb
    got = fn(x, labels, pad)
    (g,) = torch.autograd.grad(got.sum(), x)
    np.testing.assert_allclose(got.detach().double().numpy(), want,
                               rtol=1e-5)
    assert np.abs(g.double().numpy() - want_g).max() <= \
        1e-5 * np.abs(want_g).max()


# ------------------------------------------------------------- optimizer
CHAINS = {
    # (the JAX tools' chains, the port's AdamW)
    "ocr": (lambda: optax.chain(optax.clip_by_global_norm(1.0),
                                optax.adamw(1e-3, weight_decay=1e-4)),
            lambda m: AdamW(m, 1e-3, 1e-4, 1.0)),
    "plate": (lambda: optax.chain(
        optax.clip_by_global_norm(5.0),
        optax.adamw(optax.warmup_cosine_decay_schedule(
            0.0, 2e-3, warmup_steps=2, decay_steps=5, end_value=1e-4),
            weight_decay=5e-4)),
        lambda m: AdamW(m, warmup_cosine_decay_schedule(0.0, 2e-3, 2, 5,
                                                        1e-4), 5e-4, 5.0)),
    "face": (lambda: optax.chain(optax.clip_by_global_norm(5.0),
                                 optax.adamw(1e-3)),
             lambda m: AdamW(m, 1e-3, 1e-4, 5.0)),
}


@pytest.mark.parametrize("chain", list(CHAINS))
def test_optimizer_matches_optax(chain):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.Linear(
        5, 6))
    params = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters()}
    tx = CHAINS[chain][0]()
    state = tx.init(params)
    opt = CHAINS[chain][1](model)
    rng = np.random.default_rng(1)
    for _ in range(5):
        grads = {n: rng.normal(0, 3, v.shape).astype(np.float32)
                 for n, v in params.items()}
        upd, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, upd)
        opt.step({n: torch.from_numpy(g) for n, g in grads.items()})
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params[n]), rtol=1e-6,
                                   atol=1e-9)


def test_schedule_matches_optax():
    steps, lr = 1500, 2e-3
    want = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=min(100, steps // 10 + 1), decay_steps=steps,
        end_value=lr * 0.05)
    got = warmup_cosine_decay_schedule(0.0, lr, min(100, steps // 10 + 1),
                                       steps, lr * 0.05)
    counts = np.r_[0:120, 700:705, 1495:1510]
    np.testing.assert_allclose([got(int(c)) for c in counts],
                               [float(want(jnp.int32(c))) for c in counts],
                               rtol=1e-6, atol=1e-12)


# ------------------------------------------------------------------- OCR
@pytest.fixture(scope="module")
def ocr_pair(tmp_path_factory):
    """The JAX recognizer on seeded params, and the port's loaded from the
    JAX package's own save()."""
    model = j_ocr._build_model()
    tmpl = template(lambda: model.init(jax.random.PRNGKey(0), np.zeros(
        (1, 32, 64, 1), np.float32)))
    j = j_ocr.PlateOCRNative(seeded_tree(tmpl, 3))
    path = str(tmp_path_factory.mktemp("ocr") / "ocr.npz")
    j.save(path)
    return j, PlateOCRNative.load(path, device="cpu"), path


def test_ocr_loss_and_grads_match_jax(ocr_pair, tmp_path):
    j, port, _ = ocr_pair
    images, labels, pad, _ = tpo.make_batch(4, np.random.default_rng(0), 64)

    def jax_side():
        # the loss of tools/train_plate_ocr.py:195 (nested in train())
        def loss_fn(params):
            logits = j.model.apply(params, images[..., None])
            lp = jnp.zeros(logits.shape[:2], logits.dtype)
            return optax.ctc_loss(logits, lp, labels, pad).mean()

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(j.params)
        path = str(tmp_path / "grads.npz")
        j_ocr.PlateOCRNative(grads).save(path)
        return float(loss), ocr_state_dict(path, CHARSET)

    def port_side():
        model = tpo.freeze_input_bias(port.model).train()
        loss = tpo.loss_fn(model, torch.from_numpy(images), labels, pad)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        grads = torch.autograd.grad(loss, [p for p in model.parameters()
                                           if p.requires_grad])
        return float(loss.detach()), {n: g.numpy()
                                      for n, g in zip(names, grads)}

    (jl, jg), (tl, tg) = beside(jax_side, port_side)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jg = {k: v.numpy() for k, v in jg.items() if ".bias_ih_" not in k}
    assert_grads(tg, jg)


def test_ocr_export_loads_in_jax(ocr_pair, tmp_path):
    """The port's save() of a seeded init: the JAX package's load() gives
    the port's logits."""
    port = PlateOCRNative.init_random(4, device="cpu")
    path = str(tmp_path / "port_ocr.npz")
    port.save(path)
    x = np.random.default_rng(5).uniform(-1, 1, (2, 32, 96)).astype(
        np.float32)
    want = np.asarray(j_ocr.PlateOCRNative.load(path)._jit(
        j_ocr.PlateOCRNative.load(path).params, x[..., None]))
    got = port.logits(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# ------------------------------------------------------- plate detector
def plate_inputs(seed=0, size=64):
    rng = np.random.default_rng(seed)
    imgs = rng.random((2, size, size, 3)).astype(np.float32)
    boxes = [np.array([[6, 10, 40, 24], [30, 36, 60, 50]], np.float32),
             np.array([[2, 3, 21, 13]], np.float32)]
    targets = [tpd.build_targets(b, size) for b in boxes]
    stacked = [[np.stack([t[s][a] for t in targets]) for a in range(3)]
               for s in range(3)]
    return imgs, stacked


@pytest.fixture(scope="module")
def yolo_pair(tmp_path_factory):
    """The JAX nano detector on seeded params, and the port's loaded from
    the JAX tool's export_npz, BatchNorm tensors trainable."""
    det = j_yolo.YOLOv8NativeDetector(nc=1, reg_max=16, imgsz=320,
                                      **j_tpd.NANO)
    key = jax.random.PRNGKey(0)
    x = jnp.zeros((1, 64, 64, 3))
    bb = seeded_tree(template(lambda: det.backbone.init(key, x)), 5)

    def head_init():
        taps = det.backbone.apply(bb, x)
        return det.head.init(key, [taps["3_deep"], taps["4_deep"],
                                   taps["5_deep"]])

    det.bb_params = bb
    det.head_params = seeded_tree(template(head_init), 6)
    path = str(tmp_path_factory.mktemp("lp") / "lp.npz")
    j_tpd.export_npz(det, path)
    port = train_batch_norm_tensors(YOLOv8NativeDetector.load(
        path, device="cpu"))
    return det, port


def test_build_targets_matches_tool():
    rng = np.random.default_rng(7)
    for _ in range(5):
        xy = rng.uniform(0, 280, (4, 2))
        wh = rng.uniform(4, 150, (4, 2))
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        for a, b in zip(tpd.build_targets(boxes), j_tpd.build_targets(boxes)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_plate_loss_and_grads_match_jax(yolo_pair):
    j, port = yolo_pair
    imgs, targets = plate_inputs()

    def jax_side():
        # JAX's gradients from the tool's own make_step: a stand-in
        # transformation whose state is the gradients
        tx = optax.GradientTransformation(
            lambda p: (), lambda g, s, p=None: (
                jax.tree_util.tree_map(jnp.zeros_like, g), g))
        step = j_tpd.make_step(j, tx)
        _, grads, loss = step((j.bb_params, j.head_params), (), imgs,
                              targets)
        want = {"backbone." + k: v
                for k, v in flax_to_torch_state_dict(grads[0]).items()}
        want.update({"head." + k: v
                     for k, v in flax_to_torch_state_dict(grads[1]).items()})
        return float(loss), want

    def port_side():
        tg = [[torch.from_numpy(a) for a in s] for s in targets]
        loss = tpd.loss_fn(port, torch.from_numpy(imgs), tg)
        names = [n for n, _ in port.named_parameters()]
        grads = torch.autograd.grad(loss, list(port.parameters()))
        return float(loss.detach()), {n: g.numpy()
                                      for n, g in zip(names, grads)}

    (jl, jg), (tl, tg) = beside(jax_side, port_side)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert any(k.endswith("running_var") for k in tg)
    assert_grads(tg, jg)


def test_plate_export_loads_in_jax(tmp_path):
    port = tpd.make_model(2, device="cpu")
    path = str(tmp_path / "lp.npz")
    tpd.export_npz(port, path)
    j = jax_yolo(path)
    canvas = np.random.default_rng(0).random((1, 64, 64, 3)).astype(
        np.float32)
    jb, js = (np.asarray(a) for a in j.raw(canvas))
    tb, ts = (a.numpy() for a in port.raw(torch.from_numpy(canvas)))
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-3)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)


# ---------------------------------------------------------------- MTCNN
@pytest.fixture(scope="module")
def mtcnn_pair(tmp_path_factory):
    det = j_mtcnn.MTCNNNativeDetector()
    key = jax.random.PRNGKey(0)
    det.params = {}
    for i, (net, size) in enumerate(tfd.CROP_SIZES.items()):
        module = getattr(det, net)
        det.params[net] = seeded_tree(template(
            lambda m=module, s=size: m.init(key, jnp.zeros((1, s, s, 3)))),
            10 + i)
    path = str(tmp_path_factory.mktemp("mtcnn") / "mtcnn.npz")
    j_tfd.export_npz(det.params, path)
    return det, MTCNNNativeDetector.load(path, device="cpu")


def jax_face_loss(net, params, crops, labels, regs):
    """The loss of tools/train_face_detector.py:223-239 (nested in
    train_net())."""
    outs = net.apply(params, crops)
    reg, probs = outs[0], outs[-1]
    if probs.ndim == 4:
        probs = probs[:, 0, 0]
        reg = reg[:, 0, 0]
    is_pos = labels == 1
    is_neg = labels == 0
    is_reg = is_pos | (labels == -1)
    ce = -jnp.log(jnp.where(is_pos, probs[:, 1],
                            jnp.where(is_neg, probs[:, 0], 1.0)) + 1e-9)
    cls_loss = jnp.sum(ce * (is_pos | is_neg)) / \
        jnp.maximum(jnp.sum(is_pos | is_neg), 1)
    reg_loss = jnp.sum(jnp.sum((reg - regs) ** 2, -1) * is_reg) / \
        jnp.maximum(jnp.sum(is_reg), 1)
    return cls_loss + 0.5 * reg_loss


@pytest.mark.parametrize("net_name", list(tfd.CROP_SIZES))
def test_face_loss_and_grads_match_jax(mtcnn_pair, net_name):
    j, port = mtcnn_pair
    size = tfd.CROP_SIZES[net_name]
    crops, labels, regs = tfd.pad_batch(
        *tfd.sample_crops(np.random.default_rng(size), 1, size), 8)
    if (labels == -2).sum() == 0:  # keep a padded row in every case
        labels[-1] = -2
    net = getattr(j, net_name)

    def jax_side():
        loss, grads = jax.jit(jax.value_and_grad(
            functools.partial(jax_face_loss, net)))(
            j.params[net_name], crops, labels, regs)
        return float(loss), flax_to_torch_state_dict(grads)

    def port_side():
        module = getattr(port, net_name)
        loss = tfd.loss_fn(module, torch.from_numpy(crops),
                           torch.from_numpy(labels), torch.from_numpy(regs))
        names = [n for n, _ in module.named_parameters()]
        grads = torch.autograd.grad(loss, list(module.parameters()),
                                    allow_unused=True)
        return float(loss.detach()), {
            n: np.zeros(p.shape, np.float32) if g is None else g.numpy()
            for n, g, p in zip(names, grads, module.parameters())}

    (jl, jg), (tl, tg) = beside(jax_side, port_side)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert_grads(tg, jg)


def test_face_export_loads_in_jax(tmp_path):
    port = MTCNNNativeDetector(device="cpu").init(1)
    path = str(tmp_path / "mtcnn.npz")
    tfd.export_npz(port, path)
    j = jax_mtcnn(path)
    for net, size in (("pnet", 31), ("rnet", 24), ("onet", 48)):
        x = np.random.default_rng(size).standard_normal(
            (3, size, size, 3)).astype(np.float32)
        want = jax.jit(getattr(j, net).apply)(j.params[net], x)
        got = getattr(port, net)(torch.from_numpy(x).permute(0, 3, 1, 2))
        for w, g in zip(want, got):
            g = g.detach()
            if g.dim() == 4:
                g = g.permute(0, 2, 3, 1)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-5)


# ------------------------------------------------------------ synthesis
def iou(a, b):
    a, b = a > 0, b > 0
    return (a & b).sum() / max((a | b).sum(), 1)


def test_synth_matches_cv2():
    """Rectangles exact, INTER_AREA within one level, and the masks of the
    trainers' draws (a background's blocks and lines, a face's ellipses,
    circles and lines) at IoU >= 0.9."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    for _ in range(40):
        x1, y1 = rng.integers(0, 300, 2)
        w, h = rng.integers(15, 160, 2)
        col = rng.integers(20, 230, 3).astype(np.float32)
        a = np.zeros((320, 320, 3), np.float32)
        b = a.copy()
        cv2.rectangle(a, (int(x1), int(y1)), (int(x1 + w), int(y1 + h)),
                      col.tolist(), -1)
        synth.fill_rect(b, (int(x1), int(y1)), (int(x1 + w), int(y1 + h)),
                        col)
        np.testing.assert_array_equal(a, b)
    img = rng.uniform(0, 255, (90, 130, 3)).astype(np.float32)
    for dh, dw in ((12, 12), (24, 24), (48, 48), (30, 170), (100, 90)):
        ref = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_AREA)
        assert np.abs(synth.resize_area(img, dh, dw) - ref).max() <= 1.0
    for scene in range(20):  # a background's lines, thickness 1-3
        a = np.zeros((320, 320), np.float32)
        b = a.copy()
        for _ in range(int(rng.integers(2, 6))):
            p1 = tuple(int(v) for v in rng.integers(0, 320, 2))
            p2 = tuple(int(v) for v in rng.integers(0, 320, 2))
            t = int(rng.integers(1, 4))
            cv2.line(a, p1, p2, 1.0, t)
            synth.draw_line(b, p1, p2, 1.0, t)
        assert iou(a, b) >= 0.9, scene
    for _ in range(30):  # a face's ellipses and circles, 28-150 px
        s = int(rng.integers(28, 150))
        c = s // 2
        ax, ay = int(s * rng.uniform(0.32, 0.42)), int(s * rng.uniform(
            0.42, 0.5))
        for start, end, axes in ((0, 360, (ax, ay)),
                                 (180, 360, (ax, int(ay * 0.55))),
                                 (0, 180, (int(ax * 0.6), max(1, s // 12)))):
            a = np.zeros((s, s), np.float32)
            b = a.copy()
            cv2.ellipse(a, (c, c), axes, 0, start, end, 1.0, -1)
            synth.fill_ellipse(b, (c, c), axes, start, end, 1.0)
            assert iou(a, b) >= 0.9, (s, start, end, axes)
        r = max(1, int(s * rng.uniform(0.04, 0.07))) + 1
        a = np.zeros((s, s), np.float32)
        b = a.copy()
        cv2.circle(a, (c, c), r, 1.0, -1)
        synth.fill_circle(b, (c, c), r, 1.0)
        assert iou(a, b) >= 0.9, r


def test_batches_need_no_cv2_or_pil(monkeypatch):
    """The three trainers' batches with cv2 and PIL blocked."""
    for mod in ("cv2", "PIL", "PIL.Image", "PIL.ImageDraw",
                "PIL.ImageFont"):
        monkeypatch.setitem(sys.modules, mod, None)
    rng = np.random.default_rng(0)
    images, labels, pad, texts = tpo.make_batch(3, rng, 160)
    assert images.shape == (3, 32, 160) and len(texts) == 3
    imgs, targets, boxes = tpd.make_batch(2, rng)
    assert imgs.shape == (2, 320, 320, 3) and len(targets) == 3
    for net, size in tfd.CROP_SIZES.items():
        crops, labels, regs = tfd.pad_batch(
            *tfd.sample_crops(rng, 1, size), 8)
        assert crops.shape == (8, size, size, 3)


SLICE = ("vcm_ts_tpu_torch.data.synth",
         "vcm_ts_tpu_torch.data.make_plate_glyphs",
         "vcm_ts_tpu_torch.train.ctc",
         "vcm_ts_tpu_torch.train.detector_steps",
         "vcm_ts_tpu_torch.train_plate_ocr",
         "vcm_ts_tpu_torch.train_plate_detector",
         "vcm_ts_tpu_torch.train_face_detector")


def test_slice_imports_without_jax_cv2_or_pil():
    """The trainers and their synthesis import with jax, flax, the JAX
    package, tools/, cv2 and PIL blocked (the glyph generator imports PIL
    only when it runs)."""
    import subprocess

    code = ("import sys\n"
            "for m in ('jax', 'flax', 'vcm_ts_tpu', 'tools', 'cv2', 'PIL'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {SLICE!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
