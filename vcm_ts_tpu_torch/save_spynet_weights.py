"""Extract the SpyNet (optic_flow) weights of a DCVC-HEM checkpoint.

    python -m vcm_ts_tpu_torch.save_spynet_weights --weights-path IN \
        --out-path OUT.pth

The port's counterpart of the root save_spynet_weights.py: reads a port
checkpoint (.pt) or a reference .pth (utils/weights.read_state_dict),
keeps the `optic_flow` tensors, writes them with torch.save, and checks
the file: loaded into a fresh DMC (torch's default init, on the CPU), it
must change the optic_flow parameters and nothing else. A JAX .ckpt
raises and names the way across (utils/weights.JAX_CKPT_ROUTE).
"""

from __future__ import annotations

import argparse

import torch

from .models.dmc import DMC
from .utils.weights import read_state_dict


def check_loads_back(path: str) -> None:
    """Load the SpyNet file into a fresh DMC: only optic_flow changes."""
    model = DMC(device="cpu")
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    _, unexpected = model.load_state_dict(
        torch.load(path, map_location="cpu", weights_only=True),
        strict=False)
    if unexpected:
        raise KeyError(f"{path}: keys a DMC does not have: {unexpected[:10]}")
    changed = {}
    for key, value in model.state_dict().items():
        group = key.split(".")[0]
        changed[group] = changed.get(group, False) or not torch.equal(
            value, fresh[key])
    for group, moved in changed.items():
        if group == "optic_flow":
            assert moved, "optic_flow weights were not loaded"
        else:
            assert not moved, f"unexpected change in {group}"


def save_weights(weights_path: str, out_path: str) -> dict:
    new_state_dict = {name: param
                      for name, param in read_state_dict(weights_path).items()
                      if "optic_flow" in name}
    torch.save(new_state_dict, out_path)
    check_loads_back(out_path)
    return new_state_dict


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Save SpyNet weights in pth file from DCVC-HEM model")
    parser.add_argument("--weights-path", dest="weights_path", type=str,
                        required=True)
    parser.add_argument("--out-path", dest="out_path", type=str, required=True)
    args = parser.parse_args(argv)
    sd = save_weights(args.weights_path, args.out_path)
    print("Save SpyNet weights in " + args.out_path)
    for name in sorted(sd):
        print(name)
    return sd


if __name__ == "__main__":
    main()
