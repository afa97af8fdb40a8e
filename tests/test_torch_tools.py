"""PyTorch port, the weight tools and the dataset check (save_dcvc_weights,
save_spynet_weights, test_weights, test_dataset as `python -m
vcm_ts_tpu_torch.<tool>`) against the JAX system's root scripts.

Weights: the port's seeded damped DMC at 16/16/24 with 2 anchors, its
q-scale tables set to distinct values, saved three ways: a reference-style
.pth ({"model": {"dmc." + name: tensor}}), a plain .pth of the names, and
a port checkpoint (.pt, train/checkpoint.py). Each root script runs its
.pth branch on the .pth files; the port's tool must write the same keys
and equal tensors and print the same lines, from the .pth and from the
.pt alike. save_spynet_weights' load-back check builds a full-width DMC:
on the JAX side its eager flax init is replaced by a jax.eval_shape
template of zeros (an eager init takes about a minute on the CPU), which
the loaded optic_flow weights change as the init would. test_dataset
runs headless on a tree of 64x64 tiles (the crop is then the whole tile,
so the unseeded crop position cannot part the two scripts' lines).
"""

from __future__ import annotations

import functools
import os
import sys

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from tests.conftest import repo_module
from tests.test_torch_warp_twopass import one_torch_thread  # noqa: F401
from vcm_ts_tpu_torch import (save_dcvc_weights, save_spynet_weights,
                              test_dataset, test_weights)
from vcm_ts_tpu_torch.codec.png_io import imwrite
from vcm_ts_tpu_torch.models.dmc import DMC
from vcm_ts_tpu_torch.train.checkpoint import CheckPointer
from vcm_ts_tpu_torch.utils.weights import JAX_CKPT_ROUTE, init_params


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    model = init_params(DMC(anchor_num=2, channel_mv=16, channel_N=16,
                            channel_M=24, device="cpu"), seed=0,
                        kernel_scale=0.5)
    with torch.no_grad():
        model.y_q_scale.copy_(torch.tensor([1.25, 0.5]).reshape(2, 1, 1, 1))
        model.mv_y_q_scale.copy_(torch.tensor([0.75, 0.3]).reshape(2, 1, 1,
                                                                    1))
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    paths = {"ref": str(root / "ref.pth"), "plain": str(root / "plain.pth"),
             "port": str(root / "run" / "model_epoch_000.pt")}
    torch.save({"model": {"dmc." + k: v for k, v in sd.items()}},
               paths["ref"])
    torch.save(sd, paths["plain"])
    CheckPointer(str(root / "run")).save("model_epoch_000", model, epoch=1)
    return root, sd, paths


def _run(main, argv, capsys):
    """(result, printed lines) of a port tool's main(argv)."""
    capsys.readouterr()
    out = main(argv)
    return out, capsys.readouterr().out.splitlines()


def _run_root(name, argv, capsys, monkeypatch):
    """(result, printed lines) of a root script's main() under argv."""
    mod = repo_module(name)
    monkeypatch.setattr(sys, "argv", [name + ".py"] + argv)
    capsys.readouterr()
    out = mod.main()
    return out, capsys.readouterr().out.splitlines()


def _same_tensors(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


def _io(src, out):
    return ["--weights-path", src, "--out-path", out]


@pytest.mark.parametrize("source", ["ref", "plain", "port"])
def test_save_dcvc_weights_matches_root_script(files, source, tmp_path,
                                               capsys, monkeypatch):
    """The port's .pth equals the root script's (its .pth branch, on the
    reference .pth: a port .pt holds the same weights), key for key."""
    _, sd, paths = files
    want_in = paths["plain" if source == "plain" else "ref"]
    _, want_lines = _run_root("save_dcvc_weights",
                              _io(want_in, str(tmp_path / "jax.pth")),
                              capsys, monkeypatch)
    got, lines = _run(save_dcvc_weights.main,
                      _io(paths[source], str(tmp_path / "port.pth")), capsys)
    want = torch.load(tmp_path / "jax.pth", weights_only=True)
    _same_tensors(torch.load(tmp_path / "port.pth", weights_only=True), want)
    _same_tensors(got, sd)
    assert lines[1:] == want_lines[1:] and len(lines) == len(sd) + 1
    assert lines[0] == "Save DCVC-HEM weights in " + str(tmp_path / "port.pth")


@pytest.fixture
def jax_dmc_init_template(monkeypatch):
    """The JAX DMC's init as a jax.eval_shape template of zeros."""
    from vcm_ts_tpu.models.dmc import DMC as JDMC

    def init(self, *args, **kwargs):
        shapes = jax.eval_shape(functools.partial(fnn.Module.init, self,
                                                  *args, **kwargs))
        return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      shapes)

    monkeypatch.setattr(JDMC, "init", init)


@pytest.mark.parametrize("source", ["plain", "port"])
def test_save_spynet_weights_matches_root_script(files, source, tmp_path,
                                                 capsys, monkeypatch,
                                                 jax_dmc_init_template):
    """Only the optic_flow tensors, equal to the root script's; both
    load-back checks pass (only optic_flow changes in a fresh DMC)."""
    _, sd, paths = files
    _, want_lines = _run_root("save_spynet_weights",
                              _io(paths["plain"], str(tmp_path / "jax.pth")),
                              capsys, monkeypatch)
    got, lines = _run(save_spynet_weights.main,
                      _io(paths[source], str(tmp_path / "port.pth")), capsys)
    want = torch.load(tmp_path / "jax.pth", weights_only=True)
    _same_tensors(torch.load(tmp_path / "port.pth", weights_only=True), want)
    assert got and all(k.startswith("optic_flow.") for k in got)
    assert len(got) == sum(k.startswith("optic_flow.") for k in sd)
    assert lines[1:] == want_lines[1:]


def test_spynet_load_back_check_refuses_other_groups(files, tmp_path):
    """A file that changes another group than optic_flow fails the
    load-back check."""
    _, sd, _ = files
    path = str(tmp_path / "bad.pth")
    spynet = {k: v for k, v in sd.items() if k.startswith("optic_flow.")}
    torch.save({**spynet, "feature_adaptor_P.bias": torch.full((64,), 0.5)},
               path)
    with pytest.raises(AssertionError, match="feature_adaptor_P"):
        save_spynet_weights.check_loads_back(path)


@pytest.mark.parametrize("source", ["ref", "plain", "port"])
def test_weights_prints_what_root_script_prints(files, source, capsys,
                                                monkeypatch):
    _, _, paths = files
    want_in = paths["plain" if source == "port" else source]
    _, want = _run_root("test_weights", ["--weights-path", want_in], capsys,
                        monkeypatch)
    _, got = _run(test_weights.main, ["--weights-path", paths[source]],
                  capsys)
    assert got == want
    if source != "ref":
        assert "optic_flow" in got and "y_q_scale [1.25, 0.5]" in got


@pytest.mark.parametrize("tool", [save_dcvc_weights, save_spynet_weights,
                                  test_weights])
def test_tools_refuse_jax_ckpt_naming_the_route(tool, tmp_path):
    ckpt = str(tmp_path / "model.ckpt")
    with open(ckpt, "wb") as f:
        f.write(b"\x00" * 16)
    argv = ["--weights-path", ckpt]
    if tool is not test_weights:
        argv += ["--out-path", str(tmp_path / "out.pth")]
    with pytest.raises(NotImplementedError) as e:
        tool.main(argv)
    assert JAX_CKPT_ROUTE in str(e.value)


@pytest.fixture(scope="module")
def dataset_cfg(tmp_path_factory):
    """Two training roots of 64x64 tiles (3 and 2 sequences of 4 frames)
    and a YAML naming them."""
    root = tmp_path_factory.mktemp("dataset")
    rng = np.random.default_rng(7)
    roots = []
    for name, n_seq in (("a", 3), ("b", 2)):
        for s in range(n_seq):
            d = root / name / "g" / f"seq{s}" / "raw"
            os.makedirs(d)
            base = rng.random((9, 9, 3))
            for t in range(4):
                img = np.kron(np.roll(base, t, axis=1), np.ones((8, 8, 1)))
                imwrite(str(d / f"{t:05d}.png"),
                        (img[:64, :64] * 255).astype(np.uint8))
        roots.append(str(root / name))
    cfg = root / "cfg.yaml"
    cfg.write_text(f"""DATASET:
  TYPE: SequenceDataset
  TRAIN_ROOT_DIRS: {roots}
  TRAIN_SUBDIR_LISTS: ['', '']
  SEQUENCE_LENGTH: 3
INPUT:
  IMAGE_SIZE: [64, 64]
""")
    return str(cfg), roots


def test_dataset_prints_what_root_script_prints(dataset_cfg, capsys,
                                                monkeypatch):
    cfg, roots = dataset_cfg
    argv = ["--config-file", cfg, "--headless"]
    _, want = _run_root("test_dataset", argv, capsys, monkeypatch)
    sizes, got = _run(test_dataset.main, argv, capsys)
    assert got == want
    assert sizes == {roots[0]: 3, roots[1]: 2}
    assert got[1].startswith("  sample shapes: inputs (3, 64, 64, 3)")
