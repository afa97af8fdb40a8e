"""PyTorch port, data loading: vcm_ts_tpu_torch/data against the JAX
package's vcm_ts_tpu/data on one PNG tree (written with cv2, as the JAX
package's own tests write theirs).

Both loaders are host numpy drawing from numpy generators, so with the same
seed every batch must be bit-equal: random crops (training) and center
crops (eval), shuffling per epoch, a rank's shard, the prefetching loader
against the synchronous one, and the object-detection items. The port
reads PNGs with its own codec; the JAX package reads them with cv2 in BGR
order and reverses the channels in its transforms, so a channel-order
slip shows here as unequal arrays.

Also: the modules of the port's eval harness and training loop import no
JAX, no JAX package, and no cv2 / PIL / matplotlib except where a function
guards the import (the card machine has none of them).
"""

from __future__ import annotations

import ast
import os
import threading

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from vcm_ts_tpu import data as jdata  # noqa: E402
from vcm_ts_tpu.train.config import default_training_cfg as j_cfg  # noqa: E402
from vcm_ts_tpu_torch import data as tdata  # noqa: E402
from vcm_ts_tpu_torch.utils.config import \
    default_training_cfg as t_cfg  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two roots of sequences (72x72, 3 frames; one too short), a subdir
    list for the second root, and an object-detection folder."""
    root = tmp_path_factory.mktemp("seqs")
    rng = np.random.default_rng(0)
    for r, n in (("a", 5), ("b", 3)):
        for s in range(n):
            d = root / r / "g" / f"seq{s}" / "raw"
            os.makedirs(d)
            frames = 2 if (r, s) == ("a", 4) else 3
            base = (rng.random((72, 72, 3)) * 255).astype(np.uint8)
            for t in range(frames):
                cv2.imwrite(str(d / f"{t:05d}.png"), np.roll(base, t, axis=1))
    with open(root / "b_list.txt", "w") as f:
        f.write("g/seq2\ng/seq0\n")
    od = root / "od"
    os.makedirs(od / "images")
    os.makedirs(od / "object_detection")
    for i in range(3):
        img = (rng.random((60, 68, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(od / "images" / f"{i:05d}.png"), img)
        with open(od / "object_detection" / f"{i:05d}.txt", "w") as f:
            f.write(f"{i + 1} 2 3 30 40\n7 10 11 50 52\n")
    return root


def _cfgs(tree, workers=0, **solver):
    out = []
    for make in (j_cfg, t_cfg):
        cfg = make()
        cfg.DATASET.TYPE = "SequenceDataset"
        cfg.DATASET.TRAIN_ROOT_DIRS = [str(tree / "a"), str(tree / "b")]
        cfg.DATASET.TRAIN_SUBDIR_LISTS = ["", str(tree / "b_list.txt")]
        cfg.DATASET.TEST_ROOT_DIRS = [str(tree / "a")]
        cfg.DATASET.TEST_SUBDIR_LISTS = [""]
        cfg.DATASET.TEST_OD_ROOT_DIRS = [str(tree / "od")]
        cfg.DATASET.SEQUENCE_LENGTH = 3
        cfg.INPUT.IMAGE_SIZE = [64, 56]
        cfg.DATA_LOADER.NUM_WORKERS = workers
        cfg.SOLVER.LAMBDAS = solver.get("lambdas", [85, 170])
        out.append(cfg)
    return out


def _batches(loader, epochs=(0, 1)):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out.append([(x.copy(), y.copy()) for x, y in loader])
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for ge, we in zip(got, want):
        assert len(ge) == len(we) > 0
        for (gx, gy), (wx, wy) in zip(ge, we):
            assert gx.dtype == wx.dtype == np.float32
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
def test_loader_batches_bit_equal(tree, is_train):
    jc, tc = _cfgs(tree)
    want = _batches(jdata.make_data_loader(jc, 3, is_train=is_train))
    got = _batches(tdata.make_data_loader(tc, 3, is_train=is_train))
    _assert_same(got, want)
    x = got[0][0][0]
    assert x.shape == (2, 3, 56, 64, 3)  # (N, T, H, W, C), IMAGE_SIZE W, H


def test_loader_rank_shards_bit_equal(tree):
    jc, tc = _cfgs(tree)
    for rank in (0, 1):
        loaders = []
        for mod, cfg in ((jdata, jc), (tdata, tc)):
            ds = mod.ConcatDataset([
                mod.build_dataset("SequenceDataset", d, cfg, lst, True,
                                  rng=np.random.default_rng(5))
                for d, lst in zip(cfg.DATASET.TRAIN_ROOT_DIRS,
                                  cfg.DATASET.TRAIN_SUBDIR_LISTS)])
            loaders.append(mod.DataLoader(ds, 1, shuffle=True, seed=5,
                                          rank=rank, world_size=2))
        assert len(loaders[0]) == len(loaders[1]) == 3
        _assert_same(_batches(loaders[1]), _batches(loaders[0]))


def test_prefetch_loader_matches_sync_and_stops(tree):
    """The prefetching loader yields the synchronous loader's batches; an
    early break stops its worker thread. Random crops draw from the
    loader's one numpy generator, which runs on across passes (and a
    worker reads ahead), so after a break only the eval loader (center
    crops) repeats its batches."""
    jc, tc = _cfgs(tree, workers=2)
    jc0, tc0 = _cfgs(tree, workers=0)
    pre = tdata.make_data_loader(tc, 4, is_train=True)
    assert isinstance(pre, tdata.PrefetchLoader)
    sync = tdata.make_data_loader(tc0, 4, is_train=True)
    jsync = jdata.make_data_loader(jc0, 4, is_train=True)
    want = _batches(jsync)
    _assert_same(_batches(pre), want)
    _assert_same(_batches(sync), want)
    before = threading.active_count()
    pre.set_epoch(0)
    it = iter(pre)
    first = next(it)
    it.close()
    assert threading.active_count() == before
    jsync.set_epoch(0)
    np.testing.assert_array_equal(first[0], next(iter(jsync))[0])

    pre_eval = tdata.make_data_loader(tc, 4, is_train=False)
    want_eval = _batches(jdata.make_data_loader(jc0, 4, is_train=False),
                         (0,))
    it = iter(pre_eval)
    next(it)
    it.close()
    assert threading.active_count() == before
    _assert_same(_batches(pre_eval, (0,)), want_eval)


def test_object_detection_items_equal(tree):
    jc, tc = _cfgs(tree)
    jl = jdata.make_object_detection_data_loader(jc)
    tl = tdata.make_object_detection_data_loader(tc)
    assert len(jl) == len(tl) == 3
    for (jx, ja), (tx, ta) in zip(jl, tl):
        assert tx.shape == (1, 1, 64, 72, 3)  # padded to multiples of 8
        np.testing.assert_array_equal(tx, jx)
        for k in ("boxes", "labels"):
            assert ta[0][k].dtype == ja[0][k].dtype
            np.testing.assert_array_equal(ta[0][k], ja[0][k])


# --------------------------------------------------------------- imports
# the modules of the eval harness and the training loop; matplotlib may be
# imported only inside benchmark_plot.plot_graphs, and cv2 only through
# utils/video.require_cv2
SLICE_MODULES = (
    "test_video.py", "benchmark_videos_decoding.py", "bd_rate.py",
    "benchmark_plot.py", "trainer.py", "data/__init__.py",
    "data/transforms.py", "data/sequence_dataset.py",
    "train/tensorboard.py", "train/checkpoint.py", "train/train_loop.py",
    "eval/validation.py", "utils/profiling.py", "utils/common.py",
    "utils/config.py", "train/optimizer.py", "ops/msssim.py")
BANNED = ("jax", "flax", "vcm_ts_tpu", "cv2", "PIL", "matplotlib")
ALLOWED = {("benchmark_plot.py", "plot_graphs"): {"matplotlib"}}


def _imports(tree):
    """(top-level module name, enclosing function or None) of every import."""
    out = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            f = (child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func)
            if isinstance(child, ast.Import):
                out.extend((a.name.split(".")[0], f) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((child.module.split(".")[0], f))
            visit(child, f)

    visit(tree, None)
    return out


def test_slice_modules_import_no_jax_or_host_tools():
    pkg = os.path.join(REPO, "vcm_ts_tpu_torch")
    bad = []
    for rel in SLICE_MODULES:
        with open(os.path.join(pkg, rel)) as f:
            tree = ast.parse(f.read())
        for name, func in _imports(tree):
            if name in BANNED and name not in ALLOWED.get((rel, func), ()):
                bad.append(f"{rel}: {name} (in {func or 'module'})")
    assert not bad, bad


def test_port_package_imports_no_jax():
    """No module of the port imports JAX, flax or the JAX package."""
    pkg = os.path.join(REPO, "vcm_ts_tpu_torch")
    bad = []
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            bad.extend(f"{os.path.relpath(path, pkg)}: {mod}"
                       for mod, _ in _imports(tree)
                       if mod in ("jax", "flax", "vcm_ts_tpu"))
    assert not bad, bad


STAGES_BLOCK = """SOLVER:
  LAMBDAS: [85, 170]
  STAGES:
    - ['1', 'me', 'single', 'me', 'none', '0.0001', '1', 'false']
    - ["2", all, cascade, rec, all, '0.0001', 2, false]  # a comment
OUTPUT_DIR: out
"""


@pytest.mark.parametrize("source", ["training_template", "block_stages",
                                    "dump"])
def test_training_yaml_matches_pyyaml(source, tmp_path):
    """The training settings' lists of lists (the template's multi-line
    flow STAGES, a block sequence of flow sequences, the port's own dump)
    parse to PyYAML's tree, and merge into the defaults as the JAX
    package's CfgNode merges them."""
    yaml = pytest.importorskip("yaml")
    from vcm_ts_tpu_torch.utils import config

    if source == "training_template":
        text = open(os.path.join(REPO, "configs",
                                 "cfg.yaml.template")).read()
    elif source == "block_stages":
        text = STAGES_BLOCK
    else:
        text = t_cfg().dump()
    assert config.load_yaml(text) == yaml.safe_load(text)
    path = tmp_path / "cfg.yaml"
    path.write_text(text)
    port, jax_cfg = t_cfg(), j_cfg()
    port.merge_from_file(str(path))
    jax_cfg.merge_from_file(str(path))
    assert port.to_dict() == jax_cfg.to_dict()
    assert config.load_yaml(port.dump()) == port.to_dict()
    for bad in ("A:\n  - 1\n", "A:\n- [[1]]\n", "A: [[[1]]]\n",
                "A: [[1],\n"):
        with pytest.raises(ValueError):
            config.load_yaml(bad)
