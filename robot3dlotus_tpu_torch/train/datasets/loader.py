"""Host batch loading (the port's copy of the single-process, synchronous
path of robot3dlotus_tpu/train/datasets/loader.py `KeystepBatchLoader`):
episodes in a per-epoch shuffled order, each contributing all its
keysteps, re-chunked into batches of exactly num_clouds clouds.
"""
from __future__ import annotations

import numpy as np

from .collate import collate_keystep_samples


class KeystepBatchLoader:
    """Endless batches: every epoch visits the episodes in the order of
    RandomState(shuffle_seed + epoch)."""

    def __init__(self, dataset, num_clouds, num_points, shuffle_seed=0,
                 collate_fn=None):
        self.dataset = dataset
        self.num_clouds, self.num_points = num_clouds, num_points
        self.shuffle_seed = shuffle_seed
        self.collate_fn = collate_fn or (
            lambda chunk: collate_keystep_samples(
                chunk, num_points, num_clouds=num_clouds))

    def _epoch_ids(self, epoch):
        ids = np.arange(len(self.dataset))
        np.random.RandomState(self.shuffle_seed + epoch).shuffle(ids)
        return ids

    def __iter__(self):
        if len(self.dataset) == 0:
            raise ValueError("empty dataset")
        epoch, buf = 0, []
        while True:
            for idx in self._epoch_ids(epoch):
                buf.extend(self.dataset[int(idx)])
                while len(buf) >= self.num_clouds:
                    chunk, buf = buf[:self.num_clouds], buf[self.num_clouds:]
                    yield self.collate_fn(chunk)
            epoch += 1
