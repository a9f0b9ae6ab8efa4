"""Host batch loading and prefetch onto the device (the port's copy of
robot3dlotus_tpu/train/datasets/loader.py).

KeystepBatchLoader: episodes in a per-epoch shuffled order, sharded by
process, each contributing all its keysteps, re-chunked into batches of
exactly num_clouds clouds; with num_workers > 0 a pool of worker
processes (workers.py) loads the episodes ahead of the consumer, in
submission order. MetaLoader: several loaders drawn by ratio from a seeded
RandomState, a drawn task held for accum_steps batches. PrefetchToDevice:
a producer thread that copies each host batch into pinned memory and onto
the card on a side stream while the previous step runs.
"""
from __future__ import annotations

import logging
import queue
import threading
from collections import deque
from concurrent.futures.process import BrokenProcessPool
from typing import Iterator

import numpy as np
import torch

from .collate import collate_keystep_samples
from .workers import EpisodePool

LOGGER = logging.getLogger("robot3dlotus_tpu_torch.loader")

# consecutive episodes that failed to load before the loader gives up (a
# bad disk or a corrupt store fails loudly instead of spinning)
MAX_CONSECUTIVE_FAILURES = 16


class KeystepBatchLoader:
    """Batches of num_clouds clouds. Training: endless, every epoch visits
    this process's shard of the episodes in the order of
    RandomState(shuffle_seed + epoch). Validation (one_pass): the episodes
    once, in order, the last batch collated from the clouds left
    (batch_valid marks them).

    num_workers > 0 loads episodes in that many worker processes (one pool
    for the iterator's life, shut down when it is closed), at most
    2 x num_workers ahead, each episode drawing from its own
    RandomState((seed * 1000003 + epoch * 9176 + idx) % 2**31), so the
    batches do not depend on scheduling, and passing its samples through
    worker_fn there (a picklable function: work moved off the consuming
    process; not called with 0 workers); with 0 workers episodes draw from
    the dataset's own RandomState. Re-chunking and collate_fn run in the
    consuming process, in batch order. shuffle_seed must be the same in
    every process (the shards partition one permutation); seed may
    differ."""

    def __init__(self, dataset, num_clouds, num_points, seed=0,
                 shuffle_seed=None, collate_fn=None, one_pass=False,
                 num_workers=0, process_index=0, process_count=1,
                 worker_fn=None):
        self.dataset = dataset
        self.num_clouds, self.num_points = num_clouds, num_points
        self.seed = seed
        self.shuffle_seed = seed if shuffle_seed is None else shuffle_seed
        self.one_pass = one_pass
        self.num_workers = int(num_workers)
        self.worker_fn = worker_fn
        self.process_index, self.process_count = process_index, process_count
        self.collate_fn = collate_fn or (
            lambda chunk: collate_keystep_samples(
                chunk, num_points, num_clouds=num_clouds))

    def _epoch_ids(self, epoch):
        ids = np.arange(len(self.dataset))
        if not self.one_pass:
            np.random.RandomState(self.shuffle_seed + epoch).shuffle(ids)
        return ids[self.process_index::self.process_count]

    def _load(self, idx):
        """The episode's samples, or the exception that loading raised."""
        try:
            return self.dataset[idx]
        except Exception as e:  # handed to the consumer
            return e

    def _episodes(self, epoch, pool) -> Iterator:
        ids = [int(i) for i in self._epoch_ids(epoch)]
        if pool is None:
            for idx in ids:
                yield idx, self._load(idx)
            return
        pending = deque()
        for idx in ids:
            pending.append((idx, pool.submit(idx, epoch, self.seed)))
            if len(pending) >= 2 * self.num_workers:
                i, fut = pending.popleft()
                yield i, _result(fut)
        while pending:
            i, fut = pending.popleft()
            yield i, _result(fut)

    def __iter__(self):
        if not self.one_pass and len(self._epoch_ids(0)) == 0:
            raise ValueError(
                f"empty shard: {len(self.dataset)} episodes over "
                f"{self.process_count} processes (process "
                f"{self.process_index}); the endless loader would yield "
                "nothing forever")
        pool = (EpisodePool(self.dataset, self.num_workers, self.worker_fn)
                if self.num_workers > 0 else None)
        try:
            yield from self._batches(pool)
        finally:
            if pool is not None:
                pool.close()

    def _batches(self, pool):
        epoch, buf, failures = 0, [], 0
        while True:
            for idx, samples in self._episodes(epoch, pool):
                if isinstance(samples, Exception):
                    failures += 1
                    LOGGER.warning("episode %d failed to load (%d "
                                   "consecutive): %r", idx, failures, samples)
                    if failures >= MAX_CONSECUTIVE_FAILURES:
                        raise samples
                    continue
                failures = 0
                buf.extend(samples)
                while len(buf) >= self.num_clouds:
                    chunk, buf = buf[:self.num_clouds], buf[self.num_clouds:]
                    yield self.collate_fn(chunk)
            epoch += 1
            if self.one_pass:
                if buf:
                    yield self.collate_fn(buf)
                return


def _result(fut):
    """A worker's samples or exception; an exception in carrying the
    result back (one that does not pickle) counts as the episode's. A
    broken pool raises."""
    try:
        return fut.result()
    except BrokenProcessPool:
        raise
    except Exception as e:
        return e


class MetaLoader:
    """Several loaders drawn by ratio. `loaders` maps name -> iterable or
    (iterable, ratio). Iterating yields (task_name, batch) forever; a
    drawn task is held for accum_steps consecutive batches. The task
    sequence is a function of `seed` alone (every process draws the same
    one), and the step and the drawn task live on the object, so an
    iterator made anew mid-window keeps serving the window's task."""

    def __init__(self, loaders, accum_steps: int = 1, seed: int = 0):
        assert isinstance(loaders, dict) and loaders
        self.names, ratios, self.name2iter, self.name2loader = [], [], {}, {}
        for n, l in loaders.items():
            r = 1.0
            if isinstance(l, tuple):
                l, r = l
            self.names.append(n)
            self.name2loader[n] = l
            self.name2iter[n] = iter(l)
            ratios.append(float(r))
        p = np.asarray(ratios, np.float64)
        self.probs = p / p.sum()
        self.accum_steps = max(int(accum_steps), 1)
        self.rng = np.random.RandomState(seed)
        self.step = 0
        self._task_id = 0

    def __iter__(self):
        while True:
            if self.step % self.accum_steps == 0:
                self._task_id = int(
                    self.rng.choice(len(self.names), p=self.probs))
            self.step += 1
            task = self.names[self._task_id]
            try:
                batch = next(self.name2iter[task])
            except StopIteration:
                self.name2iter[task] = iter(self.name2loader[task])
                batch = next(self.name2iter[task])
            yield task, batch


class PrefetchToDevice:
    """Host batches (dicts of numpy arrays) -> dicts of tensors on
    `device`, made by a producer thread up to `depth` batches ahead.

    On CUDA the producer copies each array into pinned host memory and
    onto the card with non_blocking copies on its own stream, then records
    an event; the consumer's stream waits on that event, and every tensor
    is marked as used by the consumer's stream (record_stream), so the
    caching allocator keeps its memory until the step that reads it is
    done. The pinned buffers come from the caching host allocator, which
    does not reuse a buffer before its copy has completed. On the CPU the
    batch becomes tensors sharing the arrays' memory.

    An exception in the producer is raised by the consumer's next();
    exhaustion raises StopIteration on every later call. close() stops the
    producer and releases the queued batches; call it when leaving the
    iterator early (the training driver does on every exit)."""

    def __init__(self, it, device="cuda", depth=2):
        self.device = torch.device(device)
        self.it = iter(it)
        self.q = queue.Queue(maxsize=depth)
        self._closed = False
        self._done = False
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        """put that gives up once close() was called."""
        while not self._closed:
            try:
                self.q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _to_device(self, batch):
        if self._stream is None:
            return {k: torch.as_tensor(v) for k, v in batch.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: torch.as_tensor(v).pin_memory().to(
                self.device, non_blocking=True) for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _work(self):
        try:
            for batch in self.it:
                if self._closed or not self._put(self._to_device(batch)):
                    return
        except Exception as e:  # raised by the consumer
            self._put(e)
        self._put(StopIteration())

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self.q.get()
        if isinstance(item, StopIteration):
            self._done = True
            raise item
        if isinstance(item, Exception):
            raise item
        batch, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    def _drain(self):
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass

    def close(self):
        """Stops the producer: drain, join, drain again (the producer may
        finish one put it was already inside), then closes the host
        iterator, whose worker pool shuts down."""
        self._closed = True
        self._done = True
        self._drain()
        self.thread.join(timeout=30)
        self._drain()
        if not self.thread.is_alive() and hasattr(self.it, "close"):
            self.it.close()
