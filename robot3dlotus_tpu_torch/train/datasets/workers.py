"""Episode loading in worker processes for KeystepBatchLoader.

A training step launches thousands of kernels from Python; loader threads
beside it hold the GIL for the per-episode Python (the keystep loop, robot
boxes, rotations) and slow every launch. The workers are processes
instead, made by a `forkserver` context: the server is a fresh interpreter
(no CUDA context, no threads of the launching process) and each worker
forks from it. As under `spawn`, each worker runs the main module again
(a script needs its `if __name__ == "__main__":` guard); the server
preloads this module and the torch and port modules the launching process
has imported, so that this re-run finds its imports done. The dataset is
pickled into every worker once; an LmdbStore reopens its files there.

Each episode draws from its own RandomState((seed * 1000003 + epoch * 9176
+ idx) % 2**31), so the batches do not depend on which worker loads what.
This module imports no torch.
"""
from __future__ import annotations

import multiprocessing as mp
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np

# the modules whose classes the datasets pickle, imported by the server
from . import keystep_dataset, motion_dataset, store, structure  # noqa: F401

_WORKER = {}


def _init(dataset, worker_fn):
    _WORKER["dataset"], _WORKER["worker_fn"] = dataset, worker_fn


def _load(idx, epoch, seed):
    """Episode idx's samples, drawn from its own RandomState and passed
    through worker_fn; or the exception that loading raised (the consumer
    counts it)."""
    dataset, worker_fn = _WORKER["dataset"], _WORKER["worker_fn"]
    try:
        rng = np.random.RandomState(
            (seed * 1000003 + epoch * 9176 + idx) % (2 ** 31))
        tv, ep = dataset.data_ids[idx]
        samples = dataset.get_episode_samples(tv, ep, rng=rng)
        return samples if worker_fn is None else worker_fn(samples)
    except Exception as e:
        return e


class EpisodePool:
    """num_workers processes holding a copy of `dataset`; submit(idx,
    epoch, seed) -> a future of _load's result. A worker that
    cannot start or dies breaks the pool: result() then raises
    BrokenProcessPool, which the loader does not count as an episode
    failure. close() cancels what has not started and joins the
    workers."""

    def __init__(self, dataset, num_workers, worker_fn=None):
        ctx = mp.get_context("forkserver")
        # read when the server starts: the first pool of the process
        ctx.set_forkserver_preload(
            [__name__] + (["torch"] if "torch" in sys.modules else []) +
            sorted(m for m in sys.modules
                   if m.startswith("robot3dlotus_tpu_torch.")))
        self._pool = ProcessPoolExecutor(
            max_workers=num_workers, mp_context=ctx, initializer=_init,
            initargs=(dataset, worker_fn))

    def submit(self, idx, epoch, seed):
        return self._pool.submit(_load, idx, epoch, seed)

    def close(self):
        self._pool.shutdown(wait=True, cancel_futures=True)
