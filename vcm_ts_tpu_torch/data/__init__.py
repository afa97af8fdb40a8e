"""Data-loading factories (the port's copy of vcm_ts_tpu/data/__init__.py).

Concatenated sequence datasets, batch size = len(SOLVER.LAMBDAS) (one row
per rate anchor), shuffling with drop_last, and a DistributedSampler-style
rank shard. Batches are host numpy, drawn with numpy's generators exactly
as the JAX package draws them, so one seed gives the same batches in
either package; the train loop moves them to the device.
"""

from __future__ import annotations

import logging

import numpy as np

from .sequence_dataset import ObjectDetectionDataset, SequenceDataset

_DATASET_TYPES = {"SequenceDataset": SequenceDataset}


def build_dataset(dtype, root_dir, cfg, dir_list, is_train, rng=None):
    return _DATASET_TYPES[dtype](root_dir, cfg, dir_list, is_train=is_train,
                                 rng=rng)


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        ds = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self.datasets[ds][idx - int(self._offsets[ds])]


class DataLoader:
    """Minimal batched loader: shuffle + drop_last + optional rank sharding.

    Yields batches stacked on axis 0: ((N, T, H, W, C), (N, T, H, W, C)).
    With world_size > 1 each rank sees a disjoint epoch shard, like torch's
    DistributedSampler(drop_last=True).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        per_rank = len(self.dataset) // self.world_size
        return per_rank // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(
                self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        per_rank = n // self.world_size
        order = order[self.rank * per_rank:(self.rank + 1) * per_rank]
        for b in range(len(self)):
            idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
            items = [self.dataset[int(i)] for i in idxs]
            inputs = np.stack([it[0] for it in items], axis=0)
            targets = np.stack([it[1] for it in items], axis=0)
            yield inputs, targets


class PrefetchLoader:
    """Background-thread prefetch around a DataLoader: the next batches'
    PNG decode and transforms run on a worker thread while the current
    train step runs on the device.

    One iteration thread (batch order is exactly the wrapped loader's, so
    runs stay reproducible); `depth` bounds the batches assembled ahead.
    The hot work (zlib inflate, numpy) releases the GIL, so a thread
    suffices.
    """

    _SENTINEL = object()

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = max(1, int(depth))

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self.loader:
                    if not _put(item):
                        return
                _put(self._SENTINEL)
            except BaseException as e:  # propagate into the consumer
                _put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():  # unblock a worker stuck on a full queue
                q.get_nowait()
            t.join(timeout=5.0)


def make_data_loader(cfg, seed: int, is_train: bool = True,
                     rank: int = 0, world_size: int = 1) -> DataLoader:
    logger = logging.getLogger("CORE")
    if is_train:
        dirs = cfg.DATASET.TRAIN_ROOT_DIRS
        lists = cfg.DATASET.TRAIN_SUBDIR_LISTS
    else:
        dirs = cfg.DATASET.TEST_ROOT_DIRS
        lists = cfg.DATASET.TEST_SUBDIR_LISTS

    rng = np.random.default_rng(seed)
    datasets = []
    for root_dir, dir_list in zip(dirs, lists):
        ds = build_dataset(cfg.DATASET.TYPE, root_dir, cfg, dir_list,
                           is_train, rng=rng)
        logger.info("Loaded dataset from '%s'. Size: %d", root_dir, len(ds))
        datasets.append(ds)
    dataset = ConcatDataset(datasets)

    batch_size = len(cfg.SOLVER.LAMBDAS)
    loader = DataLoader(dataset, batch_size, shuffle=is_train, seed=seed,
                        rank=rank, world_size=world_size)
    # DATA_LOADER.NUM_WORKERS > 0 prefetches on a background thread; 0
    # keeps the loader synchronous.
    workers = int(getattr(getattr(cfg, "DATA_LOADER", None), "NUM_WORKERS",
                          0) or 0)
    if workers > 0:
        loader = PrefetchLoader(loader, depth=max(2, workers))
    return loader


def make_object_detection_data_loader(cfg):
    datasets = [ObjectDetectionDataset(root, cfg)
                for root in cfg.DATASET.TEST_OD_ROOT_DIRS]
    ds = ConcatDataset(datasets)

    class _ODLoader:
        def __len__(self):
            return len(ds)

        def __iter__(self):
            for i in range(len(ds)):
                img, ann = ds[i]
                yield img[None], [ann]  # batch of 1, torch-loader-like

    return _ODLoader()
