"""Export trained weights as a standalone DCVC-HEM .pth.

    python -m vcm_ts_tpu_torch.save_dcvc_weights --weights-path IN \
        --out-path OUT.pth

The port's counterpart of the root save_dcvc_weights.py: reads a port
checkpoint (.pt, its "params") or a reference .pth (its "model" entry, or
the file's dict), strips the `dmc.` prefix from the keys and writes the
result with torch.save, then prints the names. A JAX .ckpt raises and
names the way across (utils/weights.JAX_CKPT_ROUTE).
"""

from __future__ import annotations

import argparse

import torch

from .utils.weights import read_state_dict


def save_weights(weights_path: str, out_path: str) -> dict:
    new_state_dict = {name.replace("dmc.", ""): param
                      for name, param in read_state_dict(weights_path).items()}
    torch.save(new_state_dict, out_path)
    return new_state_dict


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Save trained weights in pth file for DCVC-HEM model")
    parser.add_argument("--weights-path", dest="weights_path", type=str,
                        required=True)
    parser.add_argument("--out-path", dest="out_path", type=str, required=True)
    args = parser.parse_args(argv)

    sd = save_weights(args.weights_path, args.out_path)
    print("Save DCVC-HEM weights in " + args.out_path)
    for name in sorted(sd):
        print(name)
    return sd


if __name__ == "__main__":
    main()
