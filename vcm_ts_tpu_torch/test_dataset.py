"""Dataset smoke check: builds each configured training dataset and prints
its sequence count and the first sample's shapes and value range.

    python -m vcm_ts_tpu_torch.test_dataset --config-file CFG.yaml \
        [--headless] [KEY VALUE ...]

The port's counterpart of the root test_dataset.py (data.build_dataset,
utils/config.default_training_cfg). Headless only: the JAX script's cv2
window of input / target pairs is not ported; --headless is accepted so
that the same command lines run.
"""

from __future__ import annotations

import argparse

from .data import build_dataset
from .utils.config import default_training_cfg


def main(argv=None):
    parser = argparse.ArgumentParser(description="Dataset smoke check")
    parser.add_argument("--config-file", type=str, required=True)
    parser.add_argument("--headless", action="store_true",
                        help="accepted for the root script's command lines; "
                             "the port never opens a window")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = default_training_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()

    sizes = {}
    for root, lst in zip(cfg.DATASET.TRAIN_ROOT_DIRS,
                         cfg.DATASET.TRAIN_SUBDIR_LISTS):
        dataset = build_dataset(cfg.DATASET.TYPE, root, cfg, lst,
                                is_train=True)
        sizes[root] = len(dataset)
        print(f"{root}: {len(dataset)} sequences")
        if len(dataset) == 0:
            continue
        inputs, targets = dataset[0]
        print(f"  sample shapes: inputs {inputs.shape} targets "
              f"{targets.shape}, range [{inputs.min():.3f}, "
              f"{inputs.max():.3f}]")
    return sizes


if __name__ == "__main__":
    main()
