"""Episode stores (the port's copy of
robot3dlotus_tpu/train/datasets/store.py): where keystep episodes live on
the host, behind one API (taskvars(), episodes(taskvar), get(taskvar,
episode) -> record).

  * LmdbStore       — GemBench's layout: one LMDB environment per taskvar,
                      episode keys, msgpack_numpy values; read by the pure-
                      Python reader of pylmdb.py (no `lmdb` binding).
  * LmdbWriterStore — writes that layout through pylmdb.write_lmdb, one
                      single-commit environment per taskvar.
  * MsgpackDirStore — one .msgpack file per episode under
                      <root>/<taskvar>/<episode>.msgpack.
  * SyntheticStore  — procedural GemBench-shaped episodes (keysteps_bbox_pcd
                      voxel1cm records): per keystep t, xyz (n_t, 3) float
                      and rgb (n_t, 3) uint8 of a tabletop-ish scene
                      voxel-deduplicated at 1 cm; action (T+1, 8) gripper
                      pose + open; bbox_info / pose_info per arm link for
                      RobotBox. Each episode is a pure function of (seed,
                      taskvar, episode), bit-equal to the JAX package's.
                      SyntheticMotionStore adds the motion_keysteps_bbox_pcd
                      fields of the motion planner's data.

Values are msgpack with msgpack_numpy's wire format for arrays, written and
read by the port's own codec (train/serialization.py packb / unpackb): the
bytes equal the JAX package's `_pack_np`'s.
"""
from __future__ import annotations

import copy
import os
import threading
from typing import List

import numpy as np

from ...utils.robot_box import RLBENCH_ARM_LINKS, RLBENCH_GRIPPER_LINKS
from ..serialization import packb, unpackb
from .pylmdb import LmdbFileReader, write_lmdb


def _np_default(o):
    """msgpack_numpy's encoding of an ndarray (b'nd', b'type', b'kind',
    b'shape', b'data'); numpy scalars become Python numbers."""
    if isinstance(o, np.ndarray):
        if o.dtype.kind == "V":
            raise TypeError("structured ndarrays unsupported")
        return {b"nd": True, b"type": o.dtype.str, b"kind": b"",
                b"shape": list(o.shape), b"data": o.tobytes()}
    if isinstance(o, np.bool_):
        return bool(o)
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    raise TypeError(type(o))


def _pack_np(obj):
    """msgpack bytes of an episode record, arrays in msgpack_numpy's
    format (what GemBench's LMDB values hold)."""
    return packb(obj, default=_np_default)


def _np_hook(o):
    nd = o.get(b"nd", o.get("nd"))
    if nd is True:
        d = o.get(b"data", o.get("data"))
        t = o.get(b"type", o.get("type"))
        s = o.get(b"shape", o.get("shape"))
        return np.frombuffer(d, dtype=np.dtype(t)).reshape(s)
    if nd is False:  # msgpack_numpy's numpy scalar
        d = o.get(b"data", o.get("data"))
        t = o.get(b"type", o.get("type"))
        return np.frombuffer(d, dtype=np.dtype(t))[0]
    if o.get(b"__nd__") or o.get("__nd__"):  # the JAX package's old files
        d = o.get(b"d", o.get("d"))
        t = o.get(b"t", o.get("t"))
        s = o.get(b"s", o.get("s"))
        return np.frombuffer(d, dtype=np.dtype(t)).reshape(s)
    return o


def _unpack_np(buf):
    """Decodes a record: msgpack_numpy arrays and scalars, and the legacy
    '__nd__' arrays of the JAX package's early MsgpackDirStore files.
    Arrays are read-only views of the decoded bytes."""
    return unpackb(buf, object_hook=_np_hook)


class MsgpackDirStore:
    """<root>/<taskvar>/<episode>.msgpack"""

    def __init__(self, root: str):
        self.root = root

    def taskvars(self) -> List[str]:
        return sorted(d for d in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, d)))

    def episodes(self, taskvar: str) -> List[str]:
        d = os.path.join(self.root, taskvar)
        return sorted(f[:-8] for f in os.listdir(d) if f.endswith(".msgpack"))

    def get(self, taskvar: str, episode: str):
        with open(os.path.join(self.root, taskvar, episode + ".msgpack"),
                  "rb") as f:
            return _unpack_np(f.read())

    def put(self, taskvar: str, episode: str, record) -> None:
        d = os.path.join(self.root, taskvar)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, episode + ".msgpack"), "wb") as f:
            f.write(_pack_np(record))


class LmdbStore:
    """GemBench's LMDB layout: <root>/<taskvar>/data.mdb, episodes in key
    order. Each environment is opened once (under a lock) and shared: the
    reader has no mutable state after open, so threads call get()
    concurrently. A pickled store carries its root only and reopens its
    files where it is unpickled (the loader's worker processes)."""

    def __init__(self, root: str):
        self.root = root
        self._envs = {}
        self._lock = threading.Lock()

    def __getstate__(self):
        return {"root": self.root}

    def __setstate__(self, state):
        self.__init__(state["root"])

    def taskvars(self) -> List[str]:
        return sorted(d for d in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, d)))

    def _env(self, taskvar):
        env = self._envs.get(taskvar)
        if env is None:
            with self._lock:
                env = self._envs.get(taskvar)
                if env is None:
                    env = LmdbFileReader(os.path.join(self.root, taskvar))
                    self._envs[taskvar] = env
        return env

    def episodes(self, taskvar) -> List[str]:
        return [k.decode() for k in self._env(taskvar).keys()]

    def get(self, taskvar, episode):
        raw = self._env(taskvar).get(episode.encode())
        if raw is None:
            raise KeyError(f"{taskvar}/{episode}: no such episode in "
                           f"{self.root}")
        return _unpack_np(raw)

    def close(self):
        with self._lock:
            for env in self._envs.values():
                env.close()
            self._envs = {}


class LmdbWriterStore:
    """Writes GemBench's LMDB layout: records are buffered per taskvar and
    each taskvar's environment is written in one commit
    (pylmdb.write_lmdb) when the producer moves to the next taskvar and on
    close(). Writes must be taskvar-major: revisiting a taskvar already on
    disk raises (its environment would be replaced)."""

    def __init__(self, root: str):
        self.root = root
        self._pending = {}  # taskvar -> {key: bytes}
        self._flushed = set()
        os.makedirs(root, exist_ok=True)

    def put(self, taskvar: str, episode: str, record) -> None:
        if taskvar in self._flushed:
            raise ValueError(
                f"LmdbWriterStore: taskvar {taskvar!r} was already written "
                "to disk; writes must be taskvar-major (all episodes of a "
                "taskvar together)")
        for done in [tv for tv in self._pending if tv != taskvar]:
            self._flush(done)
        self._pending.setdefault(taskvar, {})[
            episode.encode("ascii")] = _pack_np(record)

    def _flush(self, taskvar):
        write_lmdb(os.path.join(self.root, taskvar),
                   self._pending.pop(taskvar))
        self._flushed.add(taskvar)

    def close(self):
        for taskvar in list(self._pending):
            self._flush(taskvar)


def open_output_store(path: str, kind: str = "auto"):
    """A writable episode store: 'lmdb' or 'auto' (GemBench's layout) or
    'msgpack' (one file per episode)."""
    if kind in ("auto", "lmdb"):
        return LmdbWriterStore(path)
    if kind == "msgpack":
        return MsgpackDirStore(path)
    raise ValueError(f"store kind {kind!r}: 'auto', 'lmdb' or 'msgpack'")


class SyntheticStore:
    """Procedural episodes (deterministic per episode id), memoised.

    action_mode 'random': keystep actions are i.i.d. draws. 'reach': every
    next-keystep action reaches the object-blob centroid with a canonical
    orientation and the gripper alternating by step, a function of the
    current observation, so a policy can learn it."""

    def __init__(self, num_taskvars=4, episodes_per_taskvar=8,
                 steps_per_episode=4, points_per_step=12000, seed=0,
                 action_mode="random"):
        self._tv = [f"synthetic_task{i}+0" for i in range(num_taskvars)]
        self._eps = [f"episode{j}" for j in range(episodes_per_taskvar)]
        self.steps = steps_per_episode
        self.npts = points_per_step
        self.seed = seed
        self.action_mode = action_mode
        self._cache = {}

    def taskvars(self):
        return list(self._tv)

    def episodes(self, taskvar):
        return list(self._eps)

    def __getstate__(self):
        # episodes are regenerated where the store is unpickled
        return dict(self.__dict__, _cache={})

    def get(self, taskvar, episode):
        key = (taskvar, episode)
        if key not in self._cache:
            self._cache[key] = self._generate(taskvar, episode)
        return copy.deepcopy(self._cache[key])

    def _generate(self, taskvar, episode):
        tvi = self._tv.index(taskvar)
        epi = self._eps.index(episode)
        rng = np.random.RandomState(self.seed * 100003 + tvi * 1009 + epi)
        T, n = self.steps, self.npts
        ws_z = 0.7505
        xyz, rgb, blob_centroids = [], [], []
        for _ in range(T):
            base = rng.uniform([-0.1, -0.35, ws_z + 0.001],
                               [0.5, 0.35, ws_z + 0.002], (n // 2, 3))
            blobs = rng.randn(n - n // 2, 3) * 0.05 + \
                rng.uniform([0.0, -0.2, ws_z + 0.05],
                            [0.4, 0.2, ws_z + 0.3], (1, 3))
            blob_centroids.append(blobs.mean(0).astype(np.float32))
            pts = np.concatenate([base, blobs], 0).astype(np.float32)
            # 1 cm voxel dedup on a packed 1-D key (|vox| < 512 per axis)
            vox = np.round(pts / 0.01).astype(np.int64) + 512
            key = (vox[:, 0] << 20) | (vox[:, 1] << 10) | vox[:, 2]
            _, idx = np.unique(key, return_index=True)
            pts = pts[np.sort(idx)]
            xyz.append(pts)
            rgb.append(rng.randint(0, 256, (len(pts), 3)).astype(np.uint8))
        if self.action_mode == "reach":
            pos = np.stack([blob_centroids[0]] + blob_centroids)
            quat = np.tile(np.array([0, 0, 0, 1], np.float32), (T + 1, 1))
            grip = (np.arange(T + 1) % 2).astype(np.float32)[:, None]
            action = np.concatenate([pos, quat, grip], 1).astype(np.float32)
        else:
            quat = rng.randn(T + 1, 4)
            quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
            action = np.concatenate([
                rng.uniform([-0.1, -0.3, ws_z], [0.5, 0.3, ws_z + 0.4],
                            (T + 1, 3)),
                quat,
                rng.randint(0, 2, (T + 1, 1)).astype(np.float64),
            ], axis=1).astype(np.float32)

        bbox_info, pose_info = {}, {}
        for link in RLBENCH_ARM_LINKS + RLBENCH_GRIPPER_LINKS:
            kind = "visual" if link in ("Panda_link0", "Panda_rightfinger",
                                        "Panda_leftfinger", "Panda_gripper") \
                else "respondable"
            bb = np.tile(np.array([-0.04, 0.04, -0.04, 0.04, -0.08, 0.08],
                                  np.float32), (T, 1))
            p = rng.uniform([-0.3, -0.4, ws_z], [0.0, 0.4, ws_z + 0.6],
                            (T, 3))
            q = rng.randn(T, 4)
            q /= np.linalg.norm(q, axis=-1, keepdims=True)
            bbox_info[f"{link}_{kind}_bbox"] = bb
            pose_info[f"{link}_{kind}_pose"] = np.concatenate(
                [p, q], 1).astype(np.float32)
        return {"xyz": xyz, "rgb": rgb, "action": action,
                "bbox_info": bbox_info, "pose_info": pose_info}


class SyntheticMotionStore(SyntheticStore):
    """Synthetic episodes with the motion_keysteps_bbox_pcd layout: the
    base record plus, per step t, `sem` (n_t,) int32 semantic ids, `trajs`
    a (L_t, 8) future trajectory (1 <= L_t <= 5), `ee_pose` (T, 8) and
    `is_new_keystep` (T,) bool."""

    def get(self, taskvar, episode):
        rec = super().get(taskvar, episode)
        tvi = self._tv.index(taskvar)
        epi = self._eps.index(episode)
        rng = np.random.RandomState(self.seed * 7919 + tvi * 131 + epi + 17)
        T = self.steps
        rec["sem"] = [rng.randint(0, 100, (len(x),)).astype(np.int32)
                      for x in rec["xyz"]]
        rec["ee_pose"] = rec["action"][:T]
        trajs = []
        for _ in range(T):
            L = rng.randint(1, 6)
            q = rng.randn(L, 4)
            q /= np.linalg.norm(q, axis=-1, keepdims=True)
            trajs.append(np.concatenate([
                rng.uniform([-0.1, -0.3, 0.76], [0.5, 0.3, 1.1], (L, 3)),
                q, rng.randint(0, 2, (L, 1)).astype(np.float64),
            ], 1).astype(np.float32))
        rec["trajs"] = trajs
        new_ks = np.zeros(T, bool)
        new_ks[0] = True
        if T > 2:
            new_ks[T // 2] = True
        rec["is_new_keystep"] = new_ks
        return rec


def open_store(path_or_kind):
    """'synthetic' (random actions), 'synthetic_motion' (the motion
    planner's layout), 'synthetic_reach' / 'synthetic_reachN' (the
    learnable reach task, 8 or N episodes per taskvar; episode generation
    is id-deterministic, so the first 8 coincide), a directory of LMDB
    environments (one holding data.mdb in its first subdirectory) or a
    MsgpackDirStore root."""
    if path_or_kind == "synthetic":
        return SyntheticStore()
    if path_or_kind == "synthetic_motion":
        return SyntheticMotionStore()
    if isinstance(path_or_kind, str) and \
            path_or_kind.startswith("synthetic_reach"):
        n = path_or_kind[len("synthetic_reach"):]
        return SyntheticStore(action_mode="reach",
                              episodes_per_taskvar=int(n) if n else 8)
    sub = [d for d in os.listdir(path_or_kind)
           if os.path.isdir(os.path.join(path_or_kind, d))]
    if sub and os.path.exists(os.path.join(path_or_kind, sub[0],
                                           "data.mdb")):
        return LmdbStore(path_or_kind)
    return MsgpackDirStore(path_or_kind)
