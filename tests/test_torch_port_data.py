"""The port's training data path against the JAX package's, on the CPU.

Stores: `_pack_np` bytes equal to the JAX `_pack_np`'s and JAX bytes
decoded; `data.mdb` written by the port's `write_lmdb` byte-identical to the
JAX writer's (small, overflow pages, a branch root, empty); each package's
LmdbStore reading the other's LmdbWriterStore; MsgpackDirStore both ways;
open_store's sniffing; the taskvar-major writer check.
Loader: batches of KeystepBatchLoader with 0 and 4 worker processes
bit-equal to the JAX loader's (0 and 4 threads) over two epochs of the
synthetic store and of an LMDB the test wrote (the same data_ids and
seeds), for both families; the empty-shard error and the failure limit (a
worker's exception reaches the consumer); an LmdbStore pickled into a
worker reopens its files; a worker that cannot start raises
BrokenProcessPool (no fallback to threads); the workers stop when the
iterator is closed;
MetaLoader's task sequence, an iterator made anew mid-window included;
PrefetchToDevice on the CPU (the same batches, errors surfaced, exhaustion,
close()). Host analytics: knn_dists within 1e-6, DBSCAN and LOF bit-equal;
keystep samples with rm_pc_outliers bit-equal. train/driver.py: TRAIN.n_workers
read, the loop fed through PrefetchToDevice and the prefetcher and the
loader's worker processes closed on every exit; the release YAML training
from an LMDB directory.
"""
import multiprocessing
import os
import pickle
import signal
import threading
from concurrent.futures.process import BrokenProcessPool

import numpy as np
import pytest
import torch
import msgpack

from robot3dlotus_tpu.train.datasets import loader as jloader
from robot3dlotus_tpu.train.datasets import pylmdb as jpylmdb
from robot3dlotus_tpu.train.datasets import store as jstore
from robot3dlotus_tpu.train.datasets.keystep_dataset import \
    KeystepDataset as JKeystepDataset
from robot3dlotus_tpu.train.datasets.motion_dataset import \
    MotionPlannerDataset as JMotionDataset
from robot3dlotus_tpu.train.datasets.motion_dataset import \
    collate_motion_samples as jcollate_motion
from robot3dlotus_tpu.utils import neighbors as jneighbors
from robot3dlotus_tpu_torch.configs import get_config
from robot3dlotus_tpu_torch.train import driver, train_simple_policy
from robot3dlotus_tpu_torch.train.datasets import loader, pylmdb, store
from robot3dlotus_tpu_torch.train.datasets.keystep_dataset import \
    KeystepDataset
from robot3dlotus_tpu_torch.train.datasets.motion_dataset import (
    MotionPlannerDataset, collate_motion_samples)
from robot3dlotus_tpu_torch.utils import neighbors
import test_torch_port_train_step as tmp_ts

DS_CFG = dict(num_points=256, taskvar_file=None, instr_embed_file=None,
              taskvar_instr_file=None, txt_embed_dim=32, augment_pc=True)


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, (a, b)
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def _equal_batches(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _stores(kind):
    """(JAX store, port store) over the same episodes."""
    return (jstore.SyntheticStore(num_taskvars=2, episodes_per_taskvar=3,
                                  steps_per_episode=3, points_per_step=1500,
                                  seed=3, action_mode=kind),
            store.SyntheticStore(num_taskvars=2, episodes_per_taskvar=3,
                                 steps_per_episode=3, points_per_step=1500,
                                 seed=3, action_mode=kind))


def _lmdb_from(src, root):
    w = store.LmdbWriterStore(root)
    for tv in src.taskvars():
        for ep in src.episodes(tv):
            w.put(tv, ep, src.get(tv, ep))
    w.close()
    return root


# ------------------------------------------------------------- codec --

def test_pack_np_bytes_equal_jax():
    jsrc, _ = _stores("random")
    rec = jstore.SyntheticMotionStore(
        num_taskvars=1, episodes_per_taskvar=1, points_per_step=700).get(
        "synthetic_task0+0", "episode0")
    rec["scalars"] = [np.float32(1.5), np.int64(-3), np.bool_(True), 2.5,
                      -7, 2 ** 40, None, "text", b"raw", (1, 2)]
    rec["empty"] = np.zeros((0, 3), np.float32)
    rec["f16"] = np.arange(6, dtype=np.float16).reshape(2, 3)
    for r in (rec, jsrc.get("synthetic_task1+0", "episode2")):
        raw = jstore._pack_np(r)
        assert store._pack_np(r) == raw
        _equal_trees(store._unpack_np(raw), jstore._unpack_np(raw))


def test_unpack_np_reads_msgpack_numpy_scalars_and_legacy_arrays():
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    scalar = msgpack.packb({"s": {b"nd": False, b"type": "<i8",
                                  b"data": np.int64(7).tobytes()}},
                           use_bin_type=True)
    legacy = msgpack.packb({"y": {b"__nd__": True, b"d": arr.tobytes(),
                                  b"t": arr.dtype.str, b"s": [3, 4]}},
                           use_bin_type=True)
    for raw in (scalar, legacy):
        _equal_trees(store._unpack_np(raw), jstore._unpack_np(raw))
    assert store._unpack_np(scalar)["s"] == 7


# ----------------------------------------------------------- data.mdb --

def _lmdb_items(case):
    rng = np.random.RandomState(0)
    if case == "empty":
        return {}
    if case == "small":
        return {f"episode{i}".encode(): f"value-{i}".encode() * (i + 1)
                for i in range(10)}
    items = {b"k%05d" % i: bytes(rng.bytes(40)) for i in range(300)}
    items[b"big"] = bytes(rng.bytes(3 * 4096 + 123))     # 4-page run
    items[b"huge"] = bytes(rng.bytes(64 * 1024 + 7))     # 17-page run
    return items


@pytest.mark.parametrize("case", ["small", "overflow_and_branch", "empty"])
def test_write_lmdb_bytes_equal_jax(tmp_path, case):
    items = _lmdb_items(case)
    a = pylmdb.write_lmdb(str(tmp_path / "port"), items)
    b = jpylmdb.write_lmdb(str(tmp_path / "jax"), items)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    with pylmdb.LmdbFileReader(str(tmp_path / "jax")) as r:
        assert r.entries == len(items)
        assert dict(r.items()) == items
        assert [k for k, _ in r.items()] == sorted(items)
        for k, v in items.items():
            assert r.get(k) == v
        assert r.get(b"absent") is None


def test_lmdb_reader_rejects_garbage(tmp_path):
    p = tmp_path / "env"
    p.mkdir()
    (p / "data.mdb").write_bytes(b"\0" * 8192)
    with pytest.raises(pylmdb.LmdbFormatError):
        pylmdb.LmdbFileReader(str(p))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lmdb_stores_read_each_other(tmp_path, writer):
    src = jstore.SyntheticMotionStore(num_taskvars=2, episodes_per_taskvar=3,
                                      points_per_step=600)
    root = str(tmp_path / "lmdb")
    w = (store if writer == "port" else jstore).LmdbWriterStore(root)
    for tv in src.taskvars():
        for ep in src.episodes(tv):
            w.put(tv, ep, src.get(tv, ep))
    w.close()
    for reader in (store.LmdbStore(root), jstore.LmdbStore(root)):
        assert reader.taskvars() == src.taskvars()
        for tv in src.taskvars():
            assert reader.episodes(tv) == src.episodes(tv)
            for ep in src.episodes(tv):
                _equal_trees(reader.get(tv, ep), src.get(tv, ep))
    assert isinstance(store.open_store(root), store.LmdbStore)
    with pytest.raises(KeyError):
        store.LmdbStore(root).get(src.taskvars()[0], "episode99")


def test_writer_is_taskvar_major_and_msgpack_dirs_round_trip(tmp_path):
    rec = {"xyz": [np.ones((3, 3), np.float32)], "n": 1}
    w = store.open_output_store(str(tmp_path / "lmdb"))
    w.put("a+0", "episode0", rec)
    w.put("b+0", "episode0", rec)
    with pytest.raises(ValueError, match="taskvar-major"):
        w.put("a+0", "episode1", rec)
    for writer, reader in ((store, jstore), (jstore, store)):
        root = str(tmp_path / f"msgpack_{writer.__name__.split('.')[0]}")
        out = writer.open_output_store(root, kind="msgpack")
        out.put("a+0", "episode1", rec)
        out.put("a+0", "episode0", rec)
        got = reader.open_store(root)
        assert isinstance(got, reader.MsgpackDirStore)
        assert got.taskvars() == ["a+0"]
        assert got.episodes("a+0") == ["episode0", "episode1"]
        _equal_trees(got.get("a+0", "episode1"), rec)
    with pytest.raises(ValueError):
        store.open_output_store(str(tmp_path / "x"), kind="hdf5")


# ------------------------------------------------------------ loader --

def _loaders(kind, workers, tmp_path, motion=False):
    jsrc, psrc = _stores(kind)
    if motion:
        jsrc = jstore.SyntheticMotionStore(
            num_taskvars=2, episodes_per_taskvar=3, steps_per_episode=3,
            points_per_step=1500, seed=3)
        psrc = store.SyntheticMotionStore(
            num_taskvars=2, episodes_per_taskvar=3, steps_per_episode=3,
            points_per_step=1500, seed=3)
    if tmp_path is not None:
        root = _lmdb_from(psrc, str(tmp_path / "lmdb"))
        jsrc, psrc = jstore.LmdbStore(root), store.open_store(root)
        assert isinstance(psrc, store.LmdbStore)
    if motion:
        jds = JMotionDataset(jsrc, rng=np.random.RandomState(11), **DS_CFG)
        pds = MotionPlannerDataset(psrc, rng=np.random.RandomState(11),
                                   **DS_CFG)
        jcol = lambda c: jcollate_motion(c, 256, 5, num_clouds=4)  # noqa
        pcol = lambda c: collate_motion_samples(c, 256, 5, num_clouds=4)  # noqa
    else:
        jds = JKeystepDataset(jsrc, rng=np.random.RandomState(11), **DS_CFG)
        pds = KeystepDataset(psrc, rng=np.random.RandomState(11), **DS_CFG)
        jcol = pcol = None
    assert pds.data_ids == jds.data_ids
    jl = jloader.KeystepBatchLoader(
        jds, 4, 256, seed=5, shuffle_seed=9, process_index=0,
        process_count=1, num_workers=workers, collate_fn=jcol)
    pl = loader.KeystepBatchLoader(pds, 4, 256, seed=5, shuffle_seed=9,
                                   num_workers=workers, collate_fn=pcol)
    return jl, pl


def _take(it, n):
    out = []
    for b in it:
        out.append(b)
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("workers", [0, 4])
@pytest.mark.parametrize("source", ["synthetic", "lmdb"])
def test_loader_batches_bit_equal_jax(tmp_path, source, workers):
    """6 batches: two epochs (3 batches of 4 of the 12 keysteps)."""
    jl, pl = _loaders("reach", workers,
                      tmp_path if source == "lmdb" else None)
    _equal_batches(_take(pl, 6), _take(jl, 6))


def test_motion_loader_batches_bit_equal_jax_over_lmdb(tmp_path):
    """5 batches: past the end of the second epoch."""
    jl, pl = _loaders("random", 4, tmp_path, motion=True)
    _equal_batches(_take(pl, 5), _take(jl, 5))


@pytest.mark.parametrize("workers", [0, 4])
def test_motion_loader_batches_bit_equal_jax_synthetic(workers):
    jl, pl = _loaders("random", workers, None, motion=True)
    _equal_batches(_take(pl, 5), _take(jl, 5))


def test_lmdb_store_pickles_by_its_root(tmp_path):
    _, psrc = _stores("random")
    root = _lmdb_from(psrc, str(tmp_path / "lmdb"))
    a = store.LmdbStore(root)
    want = a.get("synthetic_task1+0", "episode2")
    b = pickle.loads(pickle.dumps(a))
    assert b.root == root and b._envs == {}
    _equal_trees(b.get("synthetic_task1+0", "episode2"), want)
    assert b._envs["synthetic_task1+0"] is not a._envs["synthetic_task1+0"]


class _Unpicklable:
    """A dataset that a worker cannot unpickle."""
    data_ids = [("t+0", "episode0")]

    def __len__(self):
        return 1

    def __reduce__(self):
        return (_refuse, ())


def _refuse():
    raise RuntimeError("this dataset does not load in a worker")


def test_worker_that_cannot_start_raises():
    it = iter(loader.KeystepBatchLoader(_Unpicklable(), 4, 16,
                                        num_workers=2))
    with pytest.raises(BrokenProcessPool):
        next(it)


def test_workers_stop_when_the_iterator_closes():
    _, psrc = _stores("random")
    ds = KeystepDataset(psrc, rng=np.random.RandomState(0), **DS_CFG)
    before = set(multiprocessing.active_children())
    it = iter(loader.KeystepBatchLoader(ds, 4, 256, num_workers=2))
    next(it)
    workers = set(multiprocessing.active_children()) - before
    assert 1 <= len(workers) <= 2
    it.close()
    assert not any(p.is_alive() for p in workers)


def test_loader_shards_and_one_pass():
    _, psrc = _stores("random")
    ds = KeystepDataset(psrc, rng=np.random.RandomState(0), **DS_CFG)
    shards = [loader.KeystepBatchLoader(ds, 4, 256, shuffle_seed=2,
                                        process_index=i, process_count=2)
              ._epoch_ids(0) for i in range(2)]
    assert sorted(np.concatenate(shards)) == list(range(len(ds)))
    with pytest.raises(ValueError, match="empty shard"):
        next(iter(loader.KeystepBatchLoader(ds, 4, 256, process_index=7,
                                            process_count=8)))
    batches = list(loader.KeystepBatchLoader(ds, 5, 256, one_pass=True))
    assert sum(int(b["batch_valid"].sum()) for b in batches) == 12
    assert not batches[-1]["batch_valid"].all()


class _Failing:
    """A dataset whose episodes all fail to load."""
    data_ids = [("t+0", f"episode{i}") for i in range(40)]

    def __len__(self):
        return len(self.data_ids)

    def __getitem__(self, idx):
        raise IOError(f"episode {idx}: bad disk")

    def get_episode_samples(self, taskvar, episode, rng=None):
        raise IOError(f"{episode}: bad disk")


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_gives_up_after_consecutive_failures(workers, caplog):
    it = iter(loader.KeystepBatchLoader(_Failing(), 4, 16,
                                        num_workers=workers))
    with caplog.at_level("WARNING"), pytest.raises(IOError, match="bad disk"):
        next(it)
    fails = [r for r in caplog.records if "failed to load" in r.getMessage()]
    assert len(fails) == loader.MAX_CONSECUTIVE_FAILURES


def test_meta_loader_task_sequence_equals_jax():
    def make(mod):
        return mod.MetaLoader({"a": (range(1000), 1.0), "b": (range(7), 3.0),
                               "c": [10, 20]}, accum_steps=3, seed=4)
    jm, pm = make(jloader), make(loader)
    want, got = [], []
    for m, out in ((jm, want), (pm, got)):
        it = iter(m)
        for i in range(40):
            out.append(next(it))
            if i in (4, 19):  # a new iterator mid-window keeps the task
                it = iter(m)
    assert got == want
    assert {t for t, _ in got} == {"a", "b", "c"}
    assert pm.step == jm.step == 40


def test_prefetch_on_cpu_same_batches_errors_and_close():
    batches = [{"x": np.full((2, 3), i, np.float32),
                "m": np.arange(2) < i} for i in range(5)]
    pre = loader.PrefetchToDevice(iter(batches), "cpu", depth=2)
    got = list(pre)
    assert len(got) == 5
    for g, b in zip(got, batches):
        assert all(isinstance(v, torch.Tensor) for v in g.values())
        np.testing.assert_array_equal(g["x"].numpy(), b["x"])
        np.testing.assert_array_equal(g["m"].numpy(), b["m"])
    for _ in range(2):      # exhausted: StopIteration again, no block
        with pytest.raises(StopIteration):
            next(pre)
    pre.close()

    def failing():
        yield batches[0]
        raise RuntimeError("loader broke")
    pre = loader.PrefetchToDevice(failing(), "cpu")
    next(pre)
    with pytest.raises(RuntimeError, match="loader broke"):
        next(pre)
    pre.close()

    closed = threading.Event()

    def endless():
        try:
            while True:
                yield batches[1]
        finally:
            closed.set()
    pre = loader.PrefetchToDevice(endless(), "cpu", depth=2)
    next(pre)
    pre.close()
    assert not pre.thread.is_alive() and pre.q.empty() and closed.is_set()
    with pytest.raises(StopIteration):
        next(pre)


# ---------------------------------------------------------- analytics --

def _cloud(seed, n=300):
    rng = np.random.RandomState(seed)
    x = np.concatenate([rng.randn(n, 3) * 0.05,
                        rng.randn(n // 3, 3) * 0.05 + 1.0,
                        rng.uniform(-3, 3, (12, 3))]).astype(np.float32)
    x[5] = x[6]          # duplicates
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_neighbors_equal_jax(seed):
    x = _cloud(seed)
    np.testing.assert_allclose(neighbors.knn_dists(x, 8),
                               jneighbors.knn_dists(x, 8), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(neighbors.dbscan_labels(x, 0.05, 5),
                                  jneighbors.dbscan_labels(x, 0.05, 5))
    for k in (5, 20, 1000):
        got = neighbors.local_outlier_factor_mask(x, k)
        np.testing.assert_array_equal(
            got, jneighbors.local_outlier_factor_mask(x, k))
    assert 0 < (~neighbors.local_outlier_factor_mask(x, 20)).sum() < 40
    with pytest.raises(ValueError):
        neighbors.knn_dists(x[:3], 3)


def test_keystep_samples_with_outlier_removal_equal_jax():
    jsrc, psrc = _stores("random")
    cfg = dict(DS_CFG, rm_pc_outliers=True, rm_pc_outliers_neighbors=25,
               num_points=4096)
    jds = JKeystepDataset(jsrc, rng=np.random.RandomState(2), **cfg)
    pds = KeystepDataset(psrc, rng=np.random.RandomState(2), **cfg)
    plain = KeystepDataset(store.SyntheticStore(
        num_taskvars=2, episodes_per_taskvar=3, steps_per_episode=3,
        points_per_step=1500, seed=3), rng=np.random.RandomState(2),
        **dict(DS_CFG, num_points=4096))
    for i in (0, 4):
        got = pds.get_episode_samples(*pds.data_ids[i],
                                      rng=np.random.RandomState(i))
        want = jds.get_episode_samples(*jds.data_ids[i],
                                       rng=np.random.RandomState(i))
        _equal_trees(got, want)
        kept = plain.get_episode_samples(*pds.data_ids[i],
                                         rng=np.random.RandomState(i))
        assert got[0]["pc_fts"].shape[0] < kept[0]["pc_fts"].shape[0]


# ------------------------------------------------------------ driver --

class _Recorded(loader.PrefetchToDevice):
    made = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.closes = 0
        _Recorded.made.append(self)

    def close(self):
        self.closes += 1
        super().close()


@pytest.mark.parametrize("exit_by", ["end", "error", "preemption"])
def test_driver_prefetches_with_workers_and_closes(tmp_path, monkeypatch,
                                                   exit_by):
    config = tmp_ts._tiny_release_config(num_train_steps=3, log_steps=1)
    config.defrost()
    config.output_dir = str(tmp_path)
    config.freeze()
    assert int(config.TRAIN.n_workers) == 4     # the release YAML's
    made = {}
    real_loader, real_step = driver.KeystepBatchLoader, driver.Trainer.step

    def make_loader(*a, **kw):
        made.update(kw)
        return real_loader(*a, **kw)

    def step(self, batch):
        assert all(isinstance(v, torch.Tensor) for v in batch.values())
        out = real_step(self, batch)
        if self.global_step == 1 and exit_by == "error":
            raise RuntimeError("step failed")
        if self.global_step == 1 and exit_by == "preemption":
            os.kill(os.getpid(), signal.SIGUSR1)
        return out
    monkeypatch.setattr(driver, "KeystepBatchLoader", make_loader)
    monkeypatch.setattr(driver, "PrefetchToDevice", _Recorded)
    monkeypatch.setattr(driver.Trainer, "step", step)
    _Recorded.made = []
    before = set(multiprocessing.active_children())
    if exit_by == "error":
        with pytest.raises(RuntimeError, match="step failed"):
            train_simple_policy.main(config, device="cpu")
    else:
        trainer = train_simple_policy.main(config, device="cpu")
        assert trainer.global_step == (3 if exit_by == "end" else 1)
    assert made["num_workers"] == 4 and made["seed"] == made["shuffle_seed"]
    (pre,) = _Recorded.made
    assert pre.closes == 1 and not pre.thread.is_alive()
    assert not set(multiprocessing.active_children()) - before  # workers


def test_release_config_trains_from_an_lmdb_directory(tmp_path, caplog):
    """The release YAML with data_dir an LMDB directory (GemBench's
    layout, written here from the synthetic reach store), two steps with
    the loader's 4 workers on the CPU, finite logged losses."""
    _, psrc = _stores("reach")
    root = _lmdb_from(psrc, str(tmp_path / "voxel1cm"))
    config = tmp_ts._tiny_release_config(num_train_steps=2, log_steps=1)
    config.defrost()
    config.output_dir = str(tmp_path / "run")
    config.TRAIN_DATASET.data_dir = root
    config.freeze()
    ds = train_simple_policy.SPEC.build_dataset(
        dict(config.TRAIN_DATASET), np.random.RandomState(0))
    assert isinstance(ds.store, store.LmdbStore) and len(ds) == 6
    with caplog.at_level("INFO", logger="robot3dlotus_tpu_torch.train"):
        trainer = train_simple_policy.main(config, device="cpu")
    assert trainer.optimizer.count == 2
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("step ")]
    assert len(lines) == 2
    for line in lines:
        for kv in line.split(": ", 1)[1].split(", "):
            assert np.isfinite(float(kv.split("=")[1])), line


def test_release_yaml_names_an_lmdb_data_dir():
    cfg = get_config(tmp_ts.RELEASE_CFG)
    assert "voxel1cm" in cfg.TRAIN_DATASET.data_dir
    with pytest.raises(FileNotFoundError):
        store.open_store(os.path.join(str(cfg.TRAIN_DATASET.data_dir),
                                      "absent"))
