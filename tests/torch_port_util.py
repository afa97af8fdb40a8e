"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both stacks; the JAX
parameters are carried into the port with the port's own
`utils/weights.state_dict_from_flax` and loaded with strict=True.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from vcm_ts_tpu_torch.utils.weights import state_dict_from_flax


def damp(params, factor=0.5):
    """The damped control: every `kernel` leaf times `factor`."""
    return jax.tree_util.tree_map_with_path(
        lambda path, v: v * factor if path[-1].key == "kernel" else v,
        params)


def to_numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def load_flax(module: torch.nn.Module, params) -> torch.nn.Module:
    """Load JAX params into a port module (strict), in eval mode."""
    module.load_state_dict(state_dict_from_flax(to_numpy_tree(params)),
                           strict=True)
    return module.eval()


def moving_frames(seed, n, size=64):
    """Seeded frames whose 8x8 blocks move one block per frame."""
    rng = np.random.default_rng(seed)
    base = rng.random((1, size // 8, size // 8, 3)).astype(np.float32)
    return [np.kron(np.roll(base, t, axis=2) + 0.01 * rng.random(base.shape),
                    np.ones((1, 8, 8, 1))).astype(np.float32)
            for t in range(n)]


def nchw(x) -> torch.Tensor:
    """NHWC numpy -> NCHW torch with channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    """NCHW torch -> NHWC numpy."""
    return t.detach().permute(0, 2, 3, 1).numpy()


def np_tree(tree):
    """Tensors (any nesting of dicts/tuples/lists) -> numpy."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(np_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
