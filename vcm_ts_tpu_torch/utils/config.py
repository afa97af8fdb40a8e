"""Settings trees: a yacs-style `CfgNode` and the codec's default settings.

The port's copy of vcm_ts_tpu/utils/config.py (`CfgNode`) and of
`default_training_cfg` and `default_codec_settings`
(vcm_ts_tpu/train/config.py), with the same keys and defaults. The GPU
machines the port runs on need not have PyYAML, so
the port reads and writes YAML itself. It knows the block-mapping subset
the settings files use:
- nested `KEY:` mappings by indentation, `# comments`;
- scalars resolved as PyYAML's YAML 1.1 resolver resolves them: null,
  bools (true/yes/on/...), ints (decimal, 0x, 0b, 0 octal), floats that
  have a dot or are .inf/.nan, '...' and "..." strings, bare strings;
- flow sequences of such scalars (`[1, 'a']`), and lists of them: a flow
  sequence of flow sequences, on one line or over several (the training
  template's STAGES), or a block sequence whose items are flow sequences
  (`- ['1', me, ...]`, as PyYAML's dump writes a list of lists).
Anything else (anchors, block sequences of scalars, multi-line scalars)
raises. `dump()` writes block YAML that PyYAML reads back to the same tree.
"""

from __future__ import annotations

import copy
import re
from typing import Any


class CfgNode(dict):
    """Attribute-accessible dict with freeze semantics (yacs-compatible)."""

    _FROZEN = "_cfg_frozen"

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any):
        if object.__getattribute__(self, CfgNode._FROZEN):
            raise AttributeError(
                f"Attempted to set {name} on a frozen CfgNode")
        self[name] = CfgNode(value) if isinstance(value, dict) and not \
            isinstance(value, CfgNode) else value

    def __setitem__(self, key, value):
        if object.__getattribute__(self, CfgNode._FROZEN):
            raise AttributeError(
                f"Attempted to set {key} on a frozen CfgNode")
        super().__setitem__(key, value)

    def freeze(self):
        object.__setattr__(self, CfgNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self):
        object.__setattr__(self, CfgNode._FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode._FROZEN)

    def clone(self) -> "CfgNode":
        node = CfgNode()
        for k, v in self.items():
            node[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return node

    def _merge_dict(self, other: dict, path: str = ""):
        for k, v in other.items():
            full = f"{path}.{k}" if path else k
            if k not in self:
                raise KeyError(f"Non-existent config key: {full}")
            cur = self[k]
            if isinstance(cur, CfgNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Cannot merge non-dict into {full}")
                cur._merge_dict(v, full)
            else:
                super().__setitem__(k, _coerce(v, cur, full))

    def merge_from_file(self, filename: str):
        frozen = self.is_frozen()
        if frozen:
            self.defrost()
        with open(filename) as f:
            data = load_yaml(f.read()) or {}
        self._merge_dict(data)
        if frozen:
            self.freeze()

    def merge_from_list(self, opts: list):
        if len(opts) % 2:
            raise ValueError("Override list must be key value pairs")
        frozen = self.is_frozen()
        if frozen:
            self.defrost()
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            if isinstance(value, str):
                try:
                    value = _value(value)
                except ValueError:
                    pass
            dict.__setitem__(node, leaf, _coerce(value, node[leaf], key))
        if frozen:
            self.freeze()

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, CfgNode) else v
                for k, v in self.items()}

    def dump(self) -> str:
        return dump_yaml(self.to_dict())

    def __str__(self):
        return self.dump()


def _coerce(value, current, key):
    """Light type checking against the default value's type."""
    if current is None or value is None:
        return value
    if isinstance(current, bool):
        if isinstance(value, bool):
            return value
        raise TypeError(f"Type mismatch for {key}: expected bool")
    if isinstance(current, (int, float)) and isinstance(value, (int, float)):
        return type(current)(value)
    if isinstance(current, (list, tuple)) and isinstance(value, (list, tuple)):
        return list(value)
    if type(current) is not type(value):
        raise TypeError(
            f"Type mismatch for {key}: expected {type(current).__name__}, "
            f"got {type(value).__name__}")
    return value


# ----------------------------------------------------------------- YAML
# PyYAML's implicit resolvers (yaml/resolver.py), without sexagesimals
_BOOL = {"yes": True, "true": True, "on": True,
         "no": False, "false": False, "off": False}
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                      r"|FALSE|on|On|ON|off|Off|OFF)$")
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT_RE = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_BASE_INT_RE = re.compile(r"^[-+]?(?:0b[0-1_]+|0x[0-9a-fA-F_]+|0[0-7_]+)$")
_FLOAT_RE = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                       r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_KEY_RE = re.compile(r"^([A-Za-z_][A-Za-z0-9_.\-]*)\s*:(?:\s+(.*))?$")


def _strip_comment(line: str) -> str:
    """The line without a trailing `# comment` (a # outside quotes that
    starts the line or follows a space)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(s: str):
    s = s.strip()
    if s.startswith("'"):
        if len(s) < 2 or not s.endswith("'"):
            raise ValueError(f"unterminated string: {s}")
        return s[1:-1].replace("''", "'")
    if s.startswith('"'):
        if len(s) < 2 or not s.endswith('"'):
            raise ValueError(f"unterminated string: {s}")
        return (s[1:-1].replace('\\"', '"').replace("\\n", "\n")
                .replace("\\t", "\t").replace("\\\\", "\\"))
    if _NULL_RE.match(s):
        return None
    if _BOOL_RE.match(s):
        return _BOOL[s.lower()]
    if _INT_RE.match(s):
        return int(s.replace("_", ""))
    if _BASE_INT_RE.match(s):
        digits = s.replace("_", "").lstrip("+-")
        sign = -1 if s.startswith("-") else 1
        base = {"0b": 2, "0x": 16}.get(digits[:2], 8)
        return sign * int(digits[2:] if base != 8 else digits, base)
    if _FLOAT_RE.match(s):
        low = s.lower()
        if low.endswith("inf"):
            return float("-inf") if s.startswith("-") else float("inf")
        if low.endswith("nan"):
            return float("nan")
        return float(s.replace("_", ""))
    if s[0] in "[]{}&*!|>%@`" or ": " in s:
        raise ValueError(f"unsupported YAML: {s}")
    return s


def _split_flow(body: str) -> list:
    """The items of a flow sequence's body, split at its top-level commas
    (an item may itself be a flow sequence of scalars)."""
    items, cur, quote, depth = [], "", None, 0
    for ch in body:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch == "," and depth == 0:
            items.append(cur)
            cur = ""
        elif ch == "[" and depth == 0 and not cur.strip():
            depth = 1
            cur += ch
        elif ch == "]" and depth == 1:
            depth = 0
            cur += ch
        elif ch in "[]{}":
            raise ValueError(f"unsupported nested flow YAML: [{body}]")
        else:
            cur += ch
    if cur.strip():
        items.append(cur)
    return items


def _value(s: str, nested: bool = True):
    s = s.strip()
    if s.startswith("[") and s.endswith("]"):
        items = [v.strip() for v in _split_flow(s[1:-1])]
        if any(v.startswith("[") for v in items) and not nested:
            raise ValueError(f"unsupported nested flow YAML: {s}")
        return [_value(v, nested=False) if v.startswith("[") else _scalar(v)
                for v in items]
    return _scalar(s)


def _open_brackets(s: str) -> int:
    """'[' minus ']' outside quotes."""
    depth, quote = 0, None
    for ch in s:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
    return depth


def load_yaml(text: str):
    """The settings files' YAML subset -> nested dicts (None when empty)."""
    root: dict = {}
    stack = [(-1, root)]  # (indent of the mapping's keys, mapping)
    pending = None  # (indent, parent dict, key) of a `KEY:` with no value
    seq = None  # (indent of the key, its list) of a block sequence
    lines = iter(enumerate(text.splitlines(), 1))
    for n, raw in lines:
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f"line {n}: tab indentation")
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if body.startswith("- "):
            item = body[2:].strip()
            if pending is not None and indent >= pending[0]:
                p_indent, p_parent, p_key = pending
                seq = (p_indent, [])
                p_parent[p_key] = seq[1]
                pending = None
            if (seq is None or indent < seq[0] or not item.startswith("[")
                    or not item.endswith("]")):
                raise ValueError(f"line {n}: unsupported YAML: {raw.strip()}")
            try:
                seq[1].append(_value(item, nested=False))
            except ValueError as e:
                raise ValueError(f"line {n}: {e}") from None
            continue
        seq = None
        m = _KEY_RE.match(body)
        if not m:
            raise ValueError(f"line {n}: unsupported YAML: {raw.strip()}")
        key, rest = m.group(1), m.group(2)
        while rest and rest.lstrip().startswith("[") and _open_brackets(
                rest) > 0:
            try:
                _, more = next(lines)
            except StopIteration:
                raise ValueError(f"line {n}: unterminated flow sequence") \
                    from None
            rest += " " + _strip_comment(more).strip()
        if pending is not None:
            p_indent, p_parent, p_key = pending
            if indent > p_indent:
                child: dict = {}
                p_parent[p_key] = child
                stack.append((indent, child))
            else:
                p_parent[p_key] = None
            pending = None
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            if stack[-1][0] == -1 and len(stack) == 1:
                stack[-1] = (indent, root)
            else:
                raise ValueError(f"line {n}: bad indentation")
        mapping = stack[-1][1]
        if key in mapping:
            raise ValueError(f"line {n}: duplicate key {key}")
        if rest is None or not rest.strip():
            mapping[key] = None
            pending = (indent, mapping, key)
        else:
            try:
                mapping[key] = _value(rest)
            except ValueError as e:
                raise ValueError(f"line {n}: {e}") from None
    return root or None


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "." not in r:  # 1e-05 must keep a dot to stay a float
            r = r.replace("e", ".0e") if "e" in r else r + ".0"
        return r
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def dump_yaml(tree: dict, indent: int = 0) -> str:
    """Nested dicts of scalars, flat lists and lists of flat lists -> block
    YAML, keys sorted."""
    out = []
    pad = " " * indent
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.append(f"{pad}{k}:" + (" {}" if not v else ""))
            if v:
                out.append(dump_yaml(v, indent + 2).rstrip("\n"))
        elif isinstance(v, (list, tuple)):
            if any(isinstance(x, dict) for x in v) or any(
                    isinstance(y, (list, tuple, dict)) for x in v
                    if isinstance(x, (list, tuple)) for y in x):
                raise TypeError(f"{k}: only lists of scalars, or lists of "
                                "such lists, are supported")
            if v and all(isinstance(x, (list, tuple)) for x in v):
                out.append(f"{pad}{k}:")
                out.extend(f"{pad}- [" + ", ".join(map(_dump_scalar, x))
                           + "]" for x in v)
            elif any(isinstance(x, (list, tuple)) for x in v):
                raise TypeError(f"{k}: mixed scalars and lists")
            else:
                out.append(f"{pad}{k}: [" + ", ".join(map(_dump_scalar, v))
                           + "]")
        else:
            out.append(f"{pad}{k}: {_dump_scalar(v)}")
    return "\n".join(out) + "\n"


def default_training_cfg() -> CfgNode:
    """The training settings tree (vcm_ts_tpu/train/config.py
    default_training_cfg): same keys and defaults."""
    cfg = CfgNode()

    cfg.MODEL = CfgNode()
    cfg.MODEL.ARCHITECTURE = "DCVC_HEM"
    cfg.MODEL.DEVICE = "tpu"
    cfg.MODEL.PRETRAINED_WEIGHTS = ""
    cfg.MODEL.I_FRAME_PRETRAINED_WEIGHTS = ""
    # [channel_mv, channel_N, channel_M]; the reference widths
    cfg.MODEL.CHANNELS = [64, 64, 96]

    cfg.INPUT = CfgNode()
    cfg.INPUT.MAKE_DIVISIBLE_BY = 8
    cfg.INPUT.IMAGE_SIZE = [256, 256]

    cfg.DATASET = CfgNode()
    cfg.DATASET.TYPE = ""
    cfg.DATASET.TRAIN_ROOT_DIRS = []
    cfg.DATASET.TRAIN_SUBDIR_LISTS = []
    cfg.DATASET.TEST_ROOT_DIRS = []
    cfg.DATASET.TEST_SUBDIR_LISTS = []
    cfg.DATASET.TEST_OD_ROOT_DIRS = []
    cfg.DATASET.SEQUENCE_LENGTH = 16
    cfg.DATASET.SEQUENCE_STRIDE = 1
    cfg.DATASET.SUBDIR_INPUTS = "raw"
    cfg.DATASET.METADATA_PATH = ""
    cfg.DATASET.OD_GOP_SIZE = 32
    cfg.DATASET.OD_STAGE = 5

    cfg.DATA_LOADER = CfgNode()
    cfg.DATA_LOADER.NUM_WORKERS = 1
    cfg.DATA_LOADER.PIN_MEMORY = True

    cfg.SOLVER = CfgNode()
    cfg.SOLVER.LAMBDAS = [85, 170, 380, 840]
    cfg.SOLVER.PL_MODEL = "resnet"
    cfg.SOLVER.PL_LAYERS = ["1", "2", "3", "4"]
    cfg.SOLVER.PL_LAMBDA = 1e1
    cfg.SOLVER.DIST_LAMBDA = 1.0
    cfg.SOLVER.LR = 1e-4
    # global-norm gradient clipping; 0 disables (the reference fine-tunes
    # pretrained weights and never clips)
    cfg.SOLVER.GRAD_CLIP_NORM = 0.0
    cfg.SOLVER.DEBUG_NANS = False
    # checkpoint each frame of a cascade chain (memory flat in p_frames)
    cfg.SOLVER.CASCADE_REMAT = True
    # bf16 compute with f32 master parameters and moments
    cfg.SOLVER.MIXED_PRECISION = False
    # gradient accumulation over G rate-anchor microbatches (divides
    # len(LAMBDAS))
    cfg.SOLVER.GRAD_ACCUM_STEPS = 1
    # 8-field stage tuples:
    # [p_frames, modules(me|rec|all), method(single|cascade),
    #  loss_dist(me|rec), loss_rate(none|me|rec|all), lr, epochs,
    #  perceptual_loss(true|false)]
    cfg.SOLVER.STAGES = [
        ["1", "me", "single", "me", "none", "0.0001", "1", "false"],
        ["1", "me", "single", "me", "me", "0.0001", "3", "false"],
        ["1", "rec", "single", "rec", "none", "0.0001", "3", "false"],
        ["1", "rec", "single", "rec", "rec", "0.0001", "3", "false"],
        ["1", "all", "single", "rec", "all", "0.0001", "6", "false"],
        ["2", "all", "single", "rec", "all", "0.0001", "5", "false"],
        ["4", "all", "single", "rec", "all", "0.0001", "3", "false"],
        ["4", "all", "single", "rec", "all", "0.00001", "1", "false"],
        ["4", "all", "cascade", "rec", "all", "0.00005", "2", "false"],
        ["4", "all", "cascade", "rec", "all", "0.00001", "3", "false"],
    ]

    cfg.OUTPUT_DIR = "outputs/test"

    cfg.TENSORBOARD = CfgNode()
    cfg.TENSORBOARD.BEST_SAMPLES_NUM = 16
    cfg.TENSORBOARD.WORST_SAMPLES_NUM = 16

    return cfg


def default_codec_settings() -> CfgNode:
    """The codec settings tree (vcm_ts_tpu/train/config.py
    default_codec_settings): same keys and defaults."""
    cfg = CfgNode()

    cfg.BASE_LAYER = CfgNode()
    cfg.BASE_LAYER.DCVC_HEM = CfgNode()
    cfg.BASE_LAYER.DCVC_HEM.I_FRAME_WEIGHTS = (
        "pretrained/acmmm2022_image_psnr.pth")
    cfg.BASE_LAYER.DCVC_HEM.P_FRAME_WEIGHTS = (
        "pretrained/acmmm2022_video_psnr.pth")
    cfg.BASE_LAYER.DCVC_HEM.ANCHOR_NUM = 4
    cfg.BASE_LAYER.DCVC_HEM.GOP = 32
    cfg.BASE_LAYER.DCVC_HEM.RATE_COUNT = 6
    cfg.BASE_LAYER.DCVC_HEM.QUALITY = 1
    cfg.BASE_LAYER.DCVC_HEM.WRITE_STREAM = True
    cfg.BASE_LAYER.DCVC_HEM.DEVICE = "tpu"

    cfg.ENHANCEMENT_LAYER = CfgNode()
    cfg.ENHANCEMENT_LAYER.DETECTORS = CfgNode()
    for det in ("FACES", "LIPLATES"):
        node = CfgNode()
        node.DEVICE = "tpu"
        node.ENABLE = True
        node.PADDING = 10
        node.PROB = 0.9
        cfg.ENHANCEMENT_LAYER.DETECTORS[det] = node
    # which codec carries the ROI residuals: "h265" = ffmpeg/x265;
    # "intra" = the learned IntraCodec (no external binaries, see
    # codec/vcm_pipeline.py encode_residuals_learned)
    cfg.ENHANCEMENT_LAYER.CODEC = "h265"
    cfg.ENHANCEMENT_LAYER.H265 = CfgNode()
    cfg.ENHANCEMENT_LAYER.H265.CRF = 25
    cfg.ENHANCEMENT_LAYER.H265.PIX_FMT = "gbrp"
    cfg.ENHANCEMENT_LAYER.H265.PRESET = "veryfast"
    cfg.ENHANCEMENT_LAYER.LEARNED = CfgNode()
    # "" = reuse BASE_LAYER.DCVC_HEM.I_FRAME_WEIGHTS
    cfg.ENHANCEMENT_LAYER.LEARNED.I_FRAME_WEIGHTS = ""
    cfg.ENHANCEMENT_LAYER.LEARNED.QUALITY = 1
    cfg.ENHANCEMENT_LAYER.LEARNED.RATE_COUNT = 6

    cfg.COMPARE = CfgNode()
    cfg.COMPARE.H265 = CfgNode()
    cfg.COMPARE.H265.PIX_FMT = "gbrp"
    cfg.COMPARE.H265.PRESET = "veryfast"

    return cfg
