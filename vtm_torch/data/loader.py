"""Dataset registry + batch loader (copy of ``vtm/data/loader.py``).

A thread-pool prefetch pipeline feeding collated numpy batches; the
entry points move them to the device. Registered: ``kinetics``, ``ssv2``,
``epickitchens``, ``charades``, ``imagenet``, ``ava``, the ``ptv*`` names and
``synthetic``. AVA items (a ``boxes`` key) go through the detection collate. Under
``MULTIGRID.SHORT_CYCLE`` the train loader walks the short cycle's three
phases (``train/multigrid.py::short_cycle_batch_sizes``), each item an
(index, phase) pair that the datasets crop by.

Data parallelism: ``BatchLoader(rank=, world=)`` forms ``vtm``'s global
batches (the same order, the same shuffle) and yields only data rank
``rank``'s contiguous block of each, decoding nothing else. A global
batch whose size ``world`` does not divide (an eval set's last) is first
padded with copies of its first item, as ``vtm``'s ``pad_to_multiple``
pads a batch; each yielded batch then says in ``"valid"`` how many of its
rows are real. The union of the ranks' valid rows, in rank order, is
``vtm``'s batch.
"""

from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List

import numpy as np

DATASET_REGISTRY: Dict[str, Callable] = {}


def register_dataset(name: str):
    def deco(cls):
        DATASET_REGISTRY[name.lower()] = cls
        return cls

    return deco


def build_dataset(dataset_name: str, cfg, split: str):
    name = dataset_name.lower()
    if name not in DATASET_REGISTRY:
        raise KeyError(
            f"Unknown dataset {dataset_name!r}; registered: {sorted(DATASET_REGISTRY)}"
        )
    return DATASET_REGISTRY[name](cfg, split)


class BatchLoader:
    """Map-style dataset -> iterator of collated numpy batches with
    thread-pool prefetch (NUM_WORKERS threads decode concurrently)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        seed: int = 0,
        short_cycle_batch_sizes=None,
        rank: int = 0,
        world: int = 1,
    ):
        if not 0 <= rank < world:
            raise ValueError(f"data rank {rank} of {world}")
        self.rank, self.world = rank, world
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.epoch = 0
        self.seed = seed
        # multigrid short cycle: 3-phase batch sizes; items become
        # (index, cycle_idx) tuples (reference multigrid_helper.py)
        self.short_cycle_batch_sizes = short_cycle_batch_sizes

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.short_cycle_batch_sizes is not None:
            # walk the same 3-phase schedule __iter__ uses — an
            # average-batch-size estimate can disagree with the real
            # batch count, which skews epoch_exact/LR math in the
            # train loops (data_size = len(loader))
            count = counter = pos = 0
            bs = self.short_cycle_batch_sizes[0]
            while pos < n:
                take = min(bs, n - pos)
                pos += bs
                if take == bs or not self.drop_last:
                    count += 1
                counter += 1
                bs = self.short_cycle_batch_sizes[counter % 3]
            return count
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[dict]:
        order: List[int] = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(order)
        if self.short_cycle_batch_sizes is not None:
            # 3-phase short-cycle batches (multigrid_helper.py:61-73)
            batches = []
            counter, pos = 0, 0
            bs = self.short_cycle_batch_sizes[0]
            while pos < len(order):
                chunk = order[pos : pos + bs]
                pos += bs
                if len(chunk) == bs or not self.drop_last:
                    batches.append([(i, counter % 3) for i in chunk])
                counter += 1
                bs = self.short_cycle_batch_sizes[counter % 3]
        else:
            batches = [
                order[i : i + self.batch_size]
                for i in range(0, len(order), self.batch_size)
            ]
            if self.drop_last and batches and len(batches[-1]) < self.batch_size:
                batches = batches[:-1]
        valid = None
        if self.world > 1:
            batches, valid = zip(*(self._rank_rows(b) for b in batches)) if batches else ((), ())
        # Item-level futures with a 2-batch-deep prefetch window. All
        # submissions happen from this (consumer) thread — worker threads
        # never submit to their own pool, so the pipeline cannot deadlock.
        from collections import deque

        prefetch_batches = 2
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending: deque = deque()
            bi = 0
            while bi < len(batches) or pending:
                while bi < len(batches) and len(pending) < prefetch_batches:
                    pending.append(
                        (bi, [pool.submit(self.dataset.__getitem__, i) for i in batches[bi]])
                    )
                    bi += 1
                index, futs = pending.popleft()
                batch = _collate([f.result() for f in futs])
                if valid is not None:
                    batch["valid"] = valid[index]
                yield batch

    def _rank_rows(self, batch: list):
        """(this rank's block of the padded global batch, how many of its
        rows are real)."""
        n = len(batch)
        padded = batch + [batch[0]] * ((-n) % self.world)
        per = len(padded) // self.world
        lo = self.rank * per
        return padded[lo:lo + per], max(0, min(per, n - lo))


def _collate(items: List[dict]) -> dict:
    if "boxes" in items[0]:
        return _detection_collate(items)
    out: dict = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], dict):
            out[key] = {k: np.asarray([v[k] for v in vals]) for k in vals[0]}
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


def _detection_collate(items: List[dict]) -> dict:
    """AVA detection collate (reference loader.detection_collate):
    variable per-item box counts are concatenated; boxes/ori_boxes get a
    leading batch-index column."""
    out: dict = {"frames": np.stack([it["frames"] for it in items])}
    out["index"] = np.asarray([it["index"] for it in items])
    out["label"] = np.concatenate([it["label"] for it in items])
    for key in ("boxes", "ori_boxes"):
        rows = []
        for bi, it in enumerate(items):
            col = np.full((len(it[key]), 1), bi, dtype=it[key].dtype)
            rows.append(np.concatenate([col, it[key]], axis=1))
        out[key] = np.concatenate(rows)
    out["metadata"] = np.concatenate([it["metadata"] for it in items])
    return out


def construct_loader(cfg, split: str, rank: int = 0, world: int = 1) -> BatchLoader:
    """Reference loader.construct_loader (loader.py:87-176): split ->
    dataset name, batch size, shuffle/drop_last policy. ``rank`` and
    ``world``: the data rank and width whose rows the loader yields."""
    assert split in ("train", "val", "test")
    if split == "train":
        dataset_name = cfg.TRAIN.DATASET
        batch_size = cfg.TRAIN.BATCH_SIZE
        shuffle, drop_last = True, True
    elif split == "val":
        dataset_name = cfg.TRAIN.DATASET
        batch_size = cfg.TRAIN.BATCH_SIZE
        shuffle, drop_last = False, False
    else:
        dataset_name = cfg.TEST.DATASET
        batch_size = cfg.TEST.BATCH_SIZE
        shuffle, drop_last = False, False
    dataset = build_dataset(dataset_name, cfg, split)
    short_cycle = None
    if split == "train" and cfg.MULTIGRID.SHORT_CYCLE:
        from vtm_torch.train.multigrid import short_cycle_batch_sizes

        short_cycle = short_cycle_batch_sizes(batch_size, cfg)
    return BatchLoader(
        dataset,
        batch_size=batch_size,
        shuffle=shuffle,
        drop_last=drop_last,
        num_workers=cfg.DATA_LOADER.NUM_WORKERS,
        seed=cfg.RNG_SEED,
        short_cycle_batch_sizes=short_cycle,
        rank=rank,
        world=world,
    )


def shuffle_dataset(loader: BatchLoader, cur_epoch: int):
    """Reference loader.shuffle_dataset (DistributedSampler.set_epoch)."""
    loader.set_epoch(cur_epoch)
