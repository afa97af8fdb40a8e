"""Carry weights into the port, and the port's own seeded init.

`state_dict_from_flax` is the port's copy of the JAX package's
utils/weight_export.py: it takes the JAX parameters as a nested dict of
numpy arrays and returns a state dict with the reference torch names,
which the port's modules load with strict=True:
- conv kernels HWIO -> OIHW, Dense kernels transposed;
- per-channel (1, 1, 1, C) vectors -> (1, C, 1, 1).

`rcnn_state_dict_from_flax` does the same for the JAX package's
Faster-RCNN (its heads carry other names than torchvision's).

`init_params` draws the JAX package's default init with a torch.Generator:
Xavier-normal with gain sqrt(2) for conv and linear weights, bias 0.01,
N(0, 0.01) for the bit estimators, ones for the q parameters. Multiplying
every weight by `kernel_scale` = 0.5 gives the "damped" control on which
streams are compared byte for byte; `make_intra` and `make_dmc` build the
seeded damped models that the port's bench and chip_smoke.py drive (no
DMC or IntraNoAR checkpoint ships in the repo).

Checkpoints: `load_torch_state_dict` reads a reference DCVC-HEM .pth with
torch.load(weights_only=True), `load_codec_weights` loads one into a port
model (every parameter must be covered; stray keys are tolerated, as the
JAX importer's strict="cover"), and the q-scale readers take the rate
anchors from one. The detector and OCR .npz files (pretrained/) load
through `yolo_state_dicts`, `mtcnn_state_dicts` and `ocr_state_dict`.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch
import torch.nn as nn

from ..entropy.bit_estimator import Bitparm

# the shipped detector and OCR weights (the repository's pretrained/)
PRETRAINED = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "pretrained")


def state_dict_from_flax(params: dict) -> dict:
    """{"params": {...}} or the inner tree -> {name: torch.Tensor}."""
    inner = params.get("params", params)
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
                continue
            v = np.asarray(v)
            if k == "kernel":
                key = prefix + ".weight" if prefix else "weight"
                v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
            elif k == "bias":
                key = prefix + ".bias" if prefix else "bias"
            else:
                key = path
                if v.ndim == 4 and v.shape[:3] == (1, 1, 1):
                    v = v.transpose(0, 3, 1, 2)
            out[key] = torch.from_numpy(np.array(v, copy=True, order="C"))

    walk(inner, "")
    return out


def rcnn_state_dict_from_flax(params: dict) -> dict:
    """The JAX package's Faster-RCNN parameters ({"body", "fpn", "rpn",
    "box"}, as eval/rcnn_native.FasterRCNNNativeDetector holds them) as a
    torchvision fasterrcnn_resnet50_fpn_v2 state dict, which the port's
    detector loads with strict=True. The heads' flax names map back to
    torchvision's: rpn conv{i} / bn{i} -> rpn.head.conv.{i}.0 / .1, cls ->
    cls_logits, bbox -> bbox_pred; box conv{i} / bn{i} ->
    roi_heads.box_head.{i}.0 / .1, fc -> roi_heads.box_head.{n + 1} for
    n convs (torchvision's layout: after the convs and the Flatten),
    cls_score / bbox_pred -> roi_heads.box_predictor.*."""
    import re

    rpn_names = {"cls": "cls_logits", "bbox": "bbox_pred"}
    n_convs = sum(1 for k in params["box"].get("params", params["box"])
                  if k.startswith("conv"))
    out = {}
    for part, prefix in (("body", "backbone.body."), ("fpn", "backbone.fpn."),
                         ("rpn", "rpn.head."), ("box", "roi_heads.")):
        for k, v in state_dict_from_flax(params[part]).items():
            head, rest = k.split(".", 1)
            m = re.fullmatch(r"(conv|bn)(\d+)", head)
            if part == "rpn":
                head = (f"conv.{m[2]}.{0 if m[1] == 'conv' else 1}" if m
                        else rpn_names[head])
            elif part == "box":
                if m:
                    head = f"box_head.{m[2]}.{0 if m[1] == 'conv' else 1}"
                elif head == "fc":
                    head = f"box_head.{n_convs + 1}"
                else:
                    head = "box_predictor." + head
            out[prefix + head + "." + rest] = v
    return out


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0,
                kernel_scale: float = 1.0) -> nn.Module:
    """Seeded init in place (the JAX package's defaults); returns model."""
    g = torch.Generator().manual_seed(seed)

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=g, dtype=torch.float32) * std)

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = m.weight
            rf = w[0, 0].numel() if w.dim() > 2 else 1
            fan_in, fan_out = w.shape[1] * rf, w.shape[0] * rf
            normal(w, math.sqrt(4.0 / (fan_in + fan_out)) * kernel_scale)
            if m.bias is not None:
                m.bias.fill_(0.01)
        elif isinstance(m, Bitparm):
            for p in (m.h, m.b, m.a):
                if p is not None:
                    normal(p, 0.01)
    return model


def make_intra(device="cuda") -> nn.Module:
    """IntraNoAR (N=192), seeded damped init (seed 0, every weight x 0.5)."""
    from ..models.intra import IntraNoAR

    return init_params(IntraNoAR(device=device), seed=0, kernel_scale=0.5)


def make_dmc(device="cuda", fast_warp: bool = False) -> nn.Module:
    """DMC (64/64/96, anchor_num 4), seeded damped init (seed 1, every
    weight x 0.5)."""
    from ..models.dmc import DMC

    return init_params(DMC(fast_warp=fast_warp, device=device), seed=1,
                       kernel_scale=0.5)


# ----------------------------------------------------------- checkpoints
def load_torch_state_dict(ckpt_path: str) -> dict:
    """A reference .pth as {name: f32 CPU tensor} (unwraps "state_dict" /
    "net" and a "module." prefix). Tensors only: weights_only=True."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    if "net" in ckpt:
        ckpt = ckpt["net"]
    return {(k[len("module."):] if k.startswith("module.") else k):
            torch.as_tensor(v) for k, v in ckpt.items()}


JAX_CKPT_ROUTE = (
    "the JAX package's training checkpoints (.ckpt) are flax msgpack, "
    "which the port does not read: export the parameters on a machine "
    "with JAX through vcm_ts_tpu/utils/weight_export.py "
    "save_torch_state_dict(params, 'model.pth') and load that .pth")


def require_pth(path: str) -> None:
    if not path.endswith(".pth"):
        raise NotImplementedError(
            f"{path}: the port loads reference .pth checkpoints here; "
            + JAX_CKPT_ROUTE)


def read_state_dict(path: str) -> dict:
    """The tensors of a weights file for the weight tools: a port
    checkpoint's "params" (train/checkpoint.py), a reference .pth's
    "model" entry, or the .pth's own dict. A JAX .ckpt raises and names
    the way across."""
    if path.endswith(".ckpt"):
        raise NotImplementedError(f"{path}: " + JAX_CKPT_ROUTE)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if "params" in blob and "extra" in blob:
        return blob["params"]
    if isinstance(blob.get("model"), dict):
        return blob["model"]
    return blob


def load_codec_weights(model: nn.Module, path: str) -> nn.Module:
    """Load a .pth into a port codec model. Every parameter and buffer of
    the model must be in the file; keys the model lacks are ignored."""
    require_pth(path)
    sd = load_torch_state_dict(path)
    missing, _ = model.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"{path} does not cover the model: {missing[:10]}"
                       f"{' ...' if len(missing) > 10 else ''}")
    return model


def get_q_scales_from_ckpt(ckpt_path: str):
    """(y_q_scales, mv_y_q_scales) of a DMC checkpoint."""
    sd = load_torch_state_dict(ckpt_path)
    return (sd["y_q_scale"].float().numpy().reshape(-1),
            sd["mv_y_q_scale"].float().numpy().reshape(-1))


def get_i_frame_q_scales_from_ckpt(ckpt_path: str):
    """q_scales of an IntraNoAR checkpoint."""
    return load_torch_state_dict(ckpt_path)["q_scale"].float().numpy(
        ).reshape(-1)


# ---------------------------------------------------- detector .npz files
def _npz(path: str):
    data = np.load(path)
    return data, json.loads(str(data["__meta__"]))


def yolo_state_dicts(npz_path: str):
    """(meta, backbone state dict, head state dict) of a YOLOv8 .npz with
    ultralytics names: "model.22." is the head; its constant `dfl.` kernel
    is not a parameter."""
    data, meta = _npz(npz_path)
    bb, head = {}, {}
    for k in data.files:
        if k.startswith("model.22."):
            if not k.startswith("model.22.dfl."):
                head[k[len("model.22."):]] = torch.from_numpy(data[k])
        elif k.startswith("model."):
            bb[k[len("model."):]] = torch.from_numpy(data[k])
    return meta, bb, head


def mtcnn_state_dicts(npz_path: str) -> dict:
    """{"pnet": sd, "rnet": sd, "onet": sd} of an MTCNN .npz (torch names)."""
    data, _ = _npz(npz_path)
    return {net: {k[len(net) + 1:]: torch.from_numpy(data[k])
                  for k in data.files if k.startswith(net + ".")}
            for net in ("pnet", "rnet", "onet")}


def ocr_state_dict(npz_path: str, charset: str) -> dict:
    """The plate-OCR .npz (a flax tree, "/"-joined names) as the port's
    PlateRecognizer state dict. Conv kernels HWIO -> OIHW, GroupNorm
    scale -> weight, dense kernels transposed. Each flax OptimizedLSTMCell
    (gates i, f, g, o, as nn.LSTM) becomes one direction of an nn.LSTM:
    the input-side layers ii/if/ig/io have no bias and the hidden-side
    ones hi/hf/hg/ho carry it, so bias_ih = 0 and bias_hh = the flax bias;
    cell 0 runs forward, cell 1 on the flipped sequence (the reverse
    direction)."""
    data, meta = _npz(npz_path)
    if meta.get("charset", charset) != charset:
        raise ValueError(f"{npz_path}: charset mismatch")
    tree: dict = {}
    for key in data.files:
        if key == "__meta__":
            continue
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(data[key])
    gates = ("i", "f", "g", "o")
    sd = {}
    for name, node in tree.items():
        if name.startswith("conv"):
            sd[name + ".weight"] = node["kernel"].transpose(3, 2, 0, 1)
            sd[name + ".bias"] = node["bias"]
        elif name.startswith("gn"):
            sd[name + ".weight"] = node["scale"]
            sd[name + ".bias"] = node["bias"]
        elif name == "head":
            sd["head.weight"] = node["kernel"].T
            sd["head.bias"] = node["bias"]
        elif name.startswith("BiLSTM_"):
            pre = "lstm" + name[len("BiLSTM_"):] + "."
            for cell, suffix in (("0", ""), ("1", "_reverse")):
                c = node["OptimizedLSTMCell_" + cell]
                sd[pre + "weight_ih_l0" + suffix] = np.concatenate(
                    [c["i" + g]["kernel"].T for g in gates])
                sd[pre + "weight_hh_l0" + suffix] = np.concatenate(
                    [c["h" + g]["kernel"].T for g in gates])
                bias = np.concatenate([c["h" + g]["bias"] for g in gates])
                sd[pre + "bias_ih_l0" + suffix] = np.zeros_like(bias)
                sd[pre + "bias_hh_l0" + suffix] = bias
        else:
            raise KeyError(f"{npz_path}: unknown OCR parameter group {name}")
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in sd.items()}
