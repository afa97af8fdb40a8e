"""Checkpoint save/load with auto-resume (the port's counterpart of
vcm_ts_tpu/train/checkpoint.py).

The port's own format: `<save_dir>/<name>.pt`, a torch.save of {"params":
the model's state_dict, "opt_state": the StageOptimizer's state_dict (step
count and moments) or None, "extra": the keyword arguments of save()}. As
in the JAX package, `last_checkpoint.txt` in save_dir names the newest
file, and on load that tag wins over an explicit path (use_latest). In a
multi-process run every rank reads and rank 0 alone writes; the file holds
whole tensors whether the run was one process, data parallel or FSDP, so
each loads strict into the others.

Loading takes the port's .pt files and reference DCVC-HEM .pth state
dicts (utils/weights). The JAX package's own .ckpt files are flax msgpack:
loading one raises and names the way across (utils/weights.JAX_CKPT_ROUTE:
the JAX package's save_torch_state_dict, run where JAX is, writes a .pth).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from ..utils import weights

_LAST_TAG = "last_checkpoint.txt"
_ZIP_MAGIC = b"PK\x03\x04"  # torch.save's container


class CheckPointer:
    def __init__(self, save_dir: str = "",
                 logger: Optional[logging.Logger] = None):
        self.save_dir = save_dir
        self.logger = logger or logging.getLogger("CORE")

    # ------------------------------------------------------------------ save
    def save(self, name: str, model, optimizer=None, **kwargs):
        """Write <name>.pt: `model` a module or its whole state_dict,
        `optimizer` a StageOptimizer, its state_dict() or None. Under
        FSDP pass the dicts that every rank gathered
        (parallel/mesh.host_copy, StageOptimizer.state_dict), from rank 0
        alone."""
        if not self.save_dir:
            return
        os.makedirs(self.save_dir, exist_ok=True)
        path = os.path.join(self.save_dir, f"{name}.pt")
        params = model if isinstance(model, dict) else model.state_dict()
        if optimizer is not None and not isinstance(optimizer, dict):
            optimizer = optimizer.state_dict()
        torch.save({
            "params": {k: v.detach().cpu() for k, v in params.items()},
            "opt_state": optimizer,
            "extra": dict(kwargs),
        }, path)
        self.tag_last_checkpoint(path)
        self.logger.info("Saved checkpoint to %s", path)

    # ------------------------------------------------------------------ load
    def _resolve(self, path: Optional[str], use_latest: bool) -> str:
        if self.has_checkpoint() and use_latest:
            return self.get_checkpoint_file()
        return path or ""

    @staticmethod
    def _read(path: str) -> dict:
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic != _ZIP_MAGIC:
            raise NotImplementedError(f"{path}: not a port checkpoint; "
                                      + weights.JAX_CKPT_ROUTE)
        return torch.load(path, map_location="cpu", weights_only=True)

    def load(self, model: torch.nn.Module, path: Optional[str] = None,
             use_latest: bool = True) -> dict:
        """Load the parameters into `model` in place (a port checkpoint
        with strict=True; a reference .pth must cover the model) and return
        the checkpoint's extra dict ({} for a .pth or no checkpoint)."""
        path = self._resolve(path, use_latest)
        if not path:
            self.logger.info("No checkpoint found.")
            return {}
        self.logger.info("Loading checkpoint from %s", path)
        if path.endswith(".pth"):
            weights.load_codec_weights(model, path)
            return {}
        blob = self._read(path)
        model.load_state_dict(blob["params"], strict=True)
        return dict(blob["extra"])

    def load_opt_state(self, path: Optional[str] = None,
                       use_latest: bool = True) -> Optional[dict]:
        """The saved StageOptimizer state (None if absent). The optimizer
        itself exists only once do_train enters the resumed stage, so
        resume callers hand this to do_train's resume_opt_state, which
        restores it on a mid-stage resume."""
        path = self._resolve(path, use_latest)
        if not path or path.endswith(".pth"):
            return None
        return self._read(path)["opt_state"]

    # ------------------------------------------------------------------ tags
    def has_checkpoint(self) -> bool:
        return bool(self.save_dir) and os.path.exists(
            os.path.join(self.save_dir, _LAST_TAG))

    def get_checkpoint_file(self) -> str:
        try:
            with open(os.path.join(self.save_dir, _LAST_TAG)) as f:
                return f.read().strip()
        except OSError:
            return ""

    def tag_last_checkpoint(self, path: str):
        with open(os.path.join(self.save_dir, _LAST_TAG), "w") as f:
            f.write(path)
