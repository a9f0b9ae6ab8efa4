"""Synthetic episode stores (the port's copy of the SyntheticStore and
open_store of robot3dlotus_tpu/train/datasets/store.py).

Episodes are procedural and GemBench-shaped (keysteps_bbox_pcd voxel1cm
records): per keystep t, xyz (n_t, 3) float and rgb (n_t, 3) uint8 of a
tabletop-ish scene voxel-deduplicated at 1 cm; action (T+1, 8) gripper
pose + open; bbox_info / pose_info per arm link for RobotBox. Each episode
is a pure function of (seed, taskvar, episode), bit-equal to the JAX
package's. SyntheticMotionStore adds the motion_keysteps_bbox_pcd fields of
the motion planner's data (per-point semantic ids, future trajectories,
gripper poses, keystep flags). The LMDB and msgpack stores of the real
GemBench data are not ported yet.
"""
from __future__ import annotations

import copy

import numpy as np

from ...utils.robot_box import RLBENCH_ARM_LINKS, RLBENCH_GRIPPER_LINKS


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
    planner's layout) or 'synthetic_reach' / 'synthetic_reachN' (the
    learnable reach task, 8 or N episodes per taskvar; episode generation
    is id-deterministic, so the first 8 coincide)."""
    if path_or_kind == "synthetic":
        return SyntheticStore()
    if path_or_kind == "synthetic_motion":
        return SyntheticMotionStore()
    if isinstance(path_or_kind, str) and \
            path_or_kind.startswith("synthetic_reach"):
        n = path_or_kind[len("synthetic_reach"):]
        return SyntheticStore(action_mode="reach",
                              episodes_per_taskvar=int(n) if n else 8)
    raise NotImplementedError(
        f"data_dir {path_or_kind!r}: the port reads only the synthetic "
        "stores; the GemBench LMDB store is not ported yet")
