"""Checkpoint inspector: the top-level key groups and the q-scale vectors.

    python -m vcm_ts_tpu_torch.test_weights --weights-path IN

The port's counterpart of the root test_weights.py, for port checkpoints
(.pt) and reference .pth files (utils/weights.read_state_dict). A JAX
.ckpt raises and names the way across (utils/weights.JAX_CKPT_ROUTE).
"""

from __future__ import annotations

import argparse

from .utils.weights import read_state_dict

Q_SCALES = ("y_q_scale", "mv_y_q_scale", "q_scale")


def parse_weights(weights_path: str):
    """({name: tensor}, the set of top-level groups)."""
    weights = read_state_dict(weights_path)
    return weights, {k.split(".")[0] for k in weights}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Model weights inspector")
    parser.add_argument("--weights-path", dest="weights_path", type=str,
                        required=True)
    args = parser.parse_args(argv)

    weights, names = parse_weights(args.weights_path)
    for name in sorted(names):
        print(name)
    for key, val in weights.items():
        if key in Q_SCALES:
            print(key, val.detach().cpu().numpy().reshape(-1).tolist())


if __name__ == "__main__":
    main()
