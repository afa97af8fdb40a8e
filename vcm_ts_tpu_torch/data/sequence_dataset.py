"""Video-sequence dataset: directories of PNG frames -> (T, H, W, C) pairs
(the port's copy of vcm_ts_tpu/data/sequence_dataset.py).

Scans `root/*/*` or an explicit subdir list, filters by minimum length,
reads T frames (stride-subsampled) and applies the transform stack; output
is NHWC float32 RGB in [0, 1]. Frames are read with the port's own PNG
codec (codec/png_io.py), not cv2 or PIL. The JAX package reads them in
cv2's BGR order and its transform stack reverses the channels; `_imread`
gives BGR too, so the same stack yields the same arrays.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from ..codec.png_io import imread
from .transforms import (Pipeline, center_crop, pad_streams_to_multiple,
                         random_crop, reverse_channels, to_float32,
                         to_unit_float)


def _imread(path):
    """(H, W, 3) uint8 in BGR order, as cv2.imread gives it."""
    return np.ascontiguousarray(imread(path)[..., ::-1])


class SequenceDataset:
    def __init__(self, root_dir, cfg, dir_list: str = "", is_train: bool = True,
                 to_tensor: bool = True, print_warn: bool = False,
                 rng: np.random.Generator | None = None):
        self.cfg = cfg
        self.root_dir = root_dir
        self.dir_list = dir_list
        self.divisible_by = cfg.INPUT.MAKE_DIVISIBLE_BY
        self.inputs_dirname_template = cfg.DATASET.SUBDIR_INPUTS
        self.seq_length = cfg.DATASET.SEQUENCE_LENGTH
        self.seq_stride = cfg.DATASET.SEQUENCE_STRIDE
        self.sequences = self.read_sequences(
            root_dir, dir_list, self.seq_length * self.seq_stride, print_warn)
        self.transforms = self.build_transforms(
            cfg.INPUT.IMAGE_SIZE, self.divisible_by, is_train, to_tensor, rng)

    def __len__(self):
        return len(self.sequences)

    def read_sequences(self, root, dir_list, min_length, print_warn=False):
        if dir_list == "":
            seqs = sorted(glob(root + "/*/*"))
        else:
            with open(dir_list) as f:
                seqs = [root + "/" + line.strip() for line in f
                        if line.strip()]
        filtered = []
        for s in seqs:
            n = len(glob(os.path.join(s, self.inputs_dirname_template, "*")))
            if n >= min_length:
                filtered.append(s)
            elif print_warn:
                print(f"Skip sequence due to length: '{s}'")
        return filtered

    def build_transforms(self, img_size, div_by=1, is_train=True,
                         to_tensor=True, rng=None):
        crop = (random_crop(img_size[0], img_size[1], rng=rng) if is_train
                else center_crop(img_size[0], img_size[1]))
        return Pipeline(
            crop,
            pad_streams_to_multiple(div_by),
            reverse_channels(),
            to_unit_float() if to_tensor else to_float32(),
        )

    def __getitem__(self, idx):
        seq_path = self.sequences[idx]
        input_paths = sorted(
            glob(os.path.join(seq_path, self.inputs_dirname_template, "*")))
        input_paths = input_paths[: self.seq_stride * self.seq_length:
                                  self.seq_stride]
        inputs = np.stack([_imread(p) for p in input_paths], axis=0)
        out = self.transforms(inputs=inputs, targets=inputs.copy())
        # (T, H, W, C) float32 RGB in [0,1]
        return out["inputs"], out["targets"]


class ObjectDetectionDataset:
    """Frames + bbox/label txt dumps (root/images/*, root/object_detection/*).
    Annotation rows: `label x1 y1 x2 y2` in absolute pixels."""

    def __init__(self, root_dir, cfg):
        self.cfg = cfg
        self.root_dir = root_dir
        self.divisible_by = cfg.INPUT.MAKE_DIVISIBLE_BY
        images = sorted(glob(root_dir + "/images/*"))
        annotations = sorted(glob(root_dir + "/object_detection/*"))
        assert len(images) == len(annotations)
        self.image_infos = [{"image": i, "annotation": a}
                            for i, a in zip(images, annotations)]
        self.transforms = Pipeline(
            pad_streams_to_multiple(self.divisible_by),
            reverse_channels(),
            to_unit_float(),
        )

    def __len__(self):
        return len(self.image_infos)

    @staticmethod
    def read_object_detection(annotation_path):
        boxes, labels = [], []
        with open(annotation_path) as f:
            for line in f.readlines():
                elements = list(map(int, line.split()))
                boxes.append(elements[1:5])
                labels.append(elements[0])
        return {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int64),
        }

    def __getitem__(self, idx):
        info = self.image_infos[idx]
        image = _imread(info["image"])[None]  # (1, H, W, C)
        annotation = self.read_object_detection(info["annotation"])
        image = self.transforms(inputs=image)["inputs"]
        return image, annotation
