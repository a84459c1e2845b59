"""Minimal host-side DataLoader of numpy batches.

Counterpart of pixelnerf_yolo_tpu/data/loader.py, with torch's
default_collate semantics: arrays gain a leading batch dim; nested
lists/tuples are collated per position (so the YOLO "bboxes"
list-of-tuples-of-arrays keeps its structure with batched leaves);
strings collect into lists.  The order of the batches (a numpy Generator
seeded ``seed``) is the JAX package's.

num_workers > 0 prefetches with a thread pool: sample loading is disk IO +
PNG decode (GIL-releasing), so threads overlap it with the train step.
Batches are still yielded strictly in order, and at most
``prefetch_factor`` batches a worker are in flight (bounded memory).
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def default_collate(batch: list):
    elem = batch[0]
    if isinstance(elem, np.ndarray):
        return np.stack(batch)
    if isinstance(elem, (np.floating, np.integer, float, int)):
        return np.array(batch)
    if isinstance(elem, str):
        return list(batch)
    if isinstance(elem, dict):
        return {k: default_collate([d[k] for d in batch]) for k in elem}
    if isinstance(elem, tuple):
        return tuple(default_collate(list(items)) for items in zip(*batch))
    if isinstance(elem, list):
        return [default_collate(list(items)) for items in zip(*batch)]
    return list(batch)


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        collate_fn=default_collate,
        num_workers: int = 0,
        prefetch_factor: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 1)
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield idx

    def _load(self, idx):
        return self.collate_fn([self.dataset[int(i)] for i in idx])

    def __iter__(self):
        if self.num_workers <= 0:
            for idx in self._batches():
                yield self._load(idx)
            return

        # ordered prefetch: submit up to num_workers * prefetch_factor
        # batches ahead; yield strictly in submission order
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            window = self.num_workers * self.prefetch_factor
            pending: deque = deque()
            it = self._batches()
            try:
                for idx in it:
                    pending.append(pool.submit(self._load, idx))
                    if len(pending) >= window:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:
                for f in pending:
                    f.cancel()
