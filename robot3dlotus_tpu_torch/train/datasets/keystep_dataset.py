"""Keystep dataset: host preprocessing for 3D-LOTUS training (the port's
copy of robot3dlotus_tpu/train/datasets/keystep_dataset.py, numpy and
scipy only).

Per keystep: table crop -> robot-box removal -> (optional Local Outlier
Factor outlier removal, utils/neighbors.py) -> point sampling
(<= num_points; a 0.95-1.0 subsample when below) -> optional z-rotation +
jitter augmentation -> centring / normalisation -> the ground-truth
rotation in the configured form -> the robot-point mask the device turns
into position targets. Samples are variable-length numpy dicts; collate.py
pads them. For one seed the samples are bit-equal to the JAX package's.
"""
from __future__ import annotations

import json
import zlib
from typing import Dict, List

import numpy as np
from scipy.spatial.transform import Rotation as R
from scipy.special import softmax

from ...configs.rlbench.constants import get_robot_workspace
from ...utils.assets import resolve_asset
from ...utils.neighbors import local_outlier_factor_mask
from ...utils.robot_box import RobotBox


def quaternion_to_discrete_euler_np(quat, resolution, gimbal_fix=True):
    """xyzw quaternion -> euler bins of `resolution` degrees, with the
    pitch snapped to +-90 inside a 1 degree gimbal band."""
    euler = R.from_quat(quat).as_euler("xyz", degrees=True)
    if gimbal_fix:
        e = np.atleast_2d(euler).copy()
        sel_hi = (89 < e[..., 1]) & (e[..., 1] < 91)
        e[sel_hi, 1] = 90
        sel_lo = (-91 < e[..., 1]) & (e[..., 1] < -89)
        e[sel_lo, 1] = -90
        e = R.from_euler("xyz", e, degrees=True).as_euler("xyz", degrees=True)
        euler = e[0] if np.ndim(euler) == 1 else e
    euler = euler + 180
    disc = np.around(euler / resolution).astype(int)
    disc[disc == int(360 / resolution)] = 0
    return disc


def quaternion_to_euler_np(quat):
    return R.from_quat(quat).as_euler("xyz", degrees=True)


def quaternion_to_ortho6d_np(quat):
    m = R.from_quat(quat).as_matrix()
    return np.concatenate([m[..., :, 0], m[..., :, 1]], axis=-1)


def random_rotate_z_np(pc, angle):
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return pc @ rot.T


class KeystepDataset:
    """Indexable over (taskvar, episode) -> list of step samples."""

    def __init__(
        self, store, taskvar_instr_file=None, instr_embed_file=None,
        taskvar_file=None, num_points=4096, xyz_shift="center", xyz_norm=False,
        use_height=True, rot_type="euler_disc", instr_embed_type="all",
        rm_table=True, rm_robot="box_keep_gripper", include_last_step=False,
        augment_pc=True, aug_max_rot=180, sample_points_by_distance=False,
        same_npoints_per_example=False, rm_pc_outliers=False,
        rm_pc_outliers_neighbors=25, euler_resolution=5, pos_type="disc",
        pos_heatmap_no_robot=True, real_robot=False, txt_embed_dim=512,
        rng=None, **unused,
    ):
        """The TRAIN_DATASET config's keys; the ones that shape the device
        targets (pos_bins, pos_bin_size, pos_heatmap_type) and the
        reference's batching flag land in `unused`."""
        self.store = store
        if taskvar_file:
            with open(resolve_asset(taskvar_file)) as f:
                self.taskvars = json.load(f)
        else:
            self.taskvars = store.taskvars()
        self.taskvar_instrs = None
        if taskvar_instr_file:
            with open(resolve_asset(taskvar_instr_file)) as f:
                self.taskvar_instrs = json.load(f)
        self.instr_embeds = None          # None: the synthetic fallback
        if instr_embed_file:
            embeds = np.load(resolve_asset(instr_embed_file),
                             allow_pickle=True).item()
            if instr_embed_type == "last":
                embeds = {k: v[-1:] for k, v in embeds.items()}
            self.instr_embeds = embeds
        self.txt_embed_dim = txt_embed_dim

        self.data_ids = []
        for tv in self.taskvars:
            try:
                eps = self.store.episodes(tv)
            except FileNotFoundError:   # a listed taskvar the store lacks
                continue
            self.data_ids.extend((tv, ep) for ep in eps)
        self.num_points = num_points
        self.xyz_shift = xyz_shift
        self.xyz_norm = xyz_norm
        self.use_height = use_height
        self.rot_type = rot_type
        self.rm_table = rm_table
        self.rm_robot = rm_robot
        self.include_last_step = include_last_step
        self.augment_pc = augment_pc
        self.aug_max_rot = np.deg2rad(aug_max_rot)
        self.sample_points_by_distance = sample_points_by_distance
        self.same_npoints_per_example = same_npoints_per_example
        self.rm_pc_outliers = rm_pc_outliers
        self.rm_pc_outliers_neighbors = rm_pc_outliers_neighbors
        self.euler_resolution = euler_resolution
        self.pos_type = pos_type
        self.pos_heatmap_no_robot = pos_heatmap_no_robot
        self.real_robot = real_robot
        self.TABLE_HEIGHT = get_robot_workspace(real_robot)["TABLE_HEIGHT"]
        self.rng = rng or np.random.RandomState()

    def __len__(self):
        return len(self.data_ids)

    def _gt_rotations(self, quats):
        """quats: (T+1, 4) gripper quaternions; step t's target rotation
        is from quaternion t+1."""
        if self.rot_type == "quat":
            return np.concatenate([quats, quats[-1:]], 0)
        if self.rot_type == "euler":
            e = quaternion_to_euler_np(quats[1:]) / 180.0
            return np.concatenate([e, e[-1:]], 0)
        if self.rot_type == "euler_disc":
            d = np.stack([quaternion_to_discrete_euler_np(
                q, self.euler_resolution) for q in quats[1:]], 0)
            return np.concatenate([d, d[-1:]], 0)
        if self.rot_type == "euler_delta":
            e = quaternion_to_euler_np(quats)
            d = (e[1:] - e[:-1]) % 360
            d[d > 180] -= 360
            return np.concatenate([d / 180.0, np.zeros((1, 3))], 0)
        if self.rot_type == "rot6d":
            o = quaternion_to_ortho6d_np(quats)
            return np.concatenate([o, o[-1:]], 0)
        raise ValueError(self.rot_type)

    def _recompute_rot(self, quat, old):
        if self.rot_type == "quat":
            return quat
        if self.rot_type == "euler":
            return quaternion_to_euler_np(quat) / 180.0
        if self.rot_type == "euler_disc":
            return quaternion_to_discrete_euler_np(quat, self.euler_resolution)
        if self.rot_type == "rot6d":
            return quaternion_to_ortho6d_np(quat)
        return old  # euler_delta: unchanged

    def _instr_embed(self, taskvar, rng):
        if self.taskvar_instrs and self.instr_embeds:
            instrs = self.taskvar_instrs[taskvar]
            instr = instrs[int(rng.randint(len(instrs)))]
            return np.asarray(self.instr_embeds[instr], np.float32)
        # deterministic pseudo-embedding per taskvar (crc32: stable across
        # processes, unlike hash())
        h = zlib.crc32(taskvar.encode("utf-8")) % (2 ** 31)
        return np.random.RandomState(h).randn(
            4, self.txt_embed_dim).astype(np.float32)

    def get_episode_samples(self, taskvar, episode, rng=None) -> List[Dict]:
        """The episode's step samples, drawn from `rng` (the loader's
        workers pass one per episode), else from the dataset's own."""
        data = self.store.get(taskvar, episode)
        rng = rng if rng is not None else self.rng
        actions = np.asarray(data["action"], np.float32)
        gt_rots = self._gt_rotations(actions[:, 3:7])
        num_steps = len(data["xyz"])
        env = "real" if self.real_robot else "rlbench"
        samples = []
        for t in range(num_steps):
            if (not self.include_last_step) and t == num_steps - 1:
                continue  # the last step is the end observation
            xyz = np.asarray(data["xyz"][t], np.float32)
            rgb = np.asarray(data["rgb"][t], np.float32)
            if self.real_robot:
                arm_links_info = (data["bbox_info"][0], data["pose_info"][0])
            else:
                arm_links_info = (
                    {k: np.asarray(v[t]) for k, v in data["bbox_info"].items()},
                    {k: np.asarray(v[t]) for k, v in data["pose_info"].items()},
                )
            gt_action = actions[t + 1].copy() if t < num_steps - 1 \
                else actions[-1].copy()
            ee_pose = actions[t].copy()
            gt_rot = gt_rots[t].copy()

            if self.rm_table:
                keep = xyz[:, 2] > self.TABLE_HEIGHT
                xyz, rgb = xyz[keep], rgb[keep]
            if self.rm_robot.startswith("box"):
                box = RobotBox(arm_links_info,
                               keep_gripper=self.rm_robot == "box_keep_gripper",
                               env_name=env)
                keep = ~box.point_mask(xyz)
                xyz, rgb = xyz[keep], rgb[keep]
            if self.rm_pc_outliers and \
                    len(xyz) > self.rm_pc_outliers_neighbors:
                keep = local_outlier_factor_mask(
                    xyz, n_neighbors=self.rm_pc_outliers_neighbors)
                xyz, rgb = xyz[keep], rgb[keep]
            if len(xyz) == 0:
                continue

            if len(xyz) > self.num_points:
                if self.sample_points_by_distance:
                    dists = np.sqrt(np.sum((xyz - ee_pose[:3]) ** 2, 1))
                    probs = 1 / np.maximum(dists, 0.1)
                    probs = np.maximum(softmax(probs), 1e-30)
                    probs = probs / probs.sum()
                    idxs = rng.choice(len(xyz), self.num_points,
                                      replace=False, p=probs)
                else:
                    idxs = rng.choice(len(xyz), self.num_points, replace=False)
            elif self.same_npoints_per_example:
                idxs = rng.choice(len(xyz), self.num_points, replace=True)
            else:
                maxn = int(len(xyz) * rng.uniform(0.95, 1))
                idxs = rng.permutation(len(xyz))[:max(maxn, 1)]
            xyz, rgb = xyz[idxs], rgb[idxs]
            height = xyz[:, 2] - self.TABLE_HEIGHT

            robot_point_idxs = None
            if self.pos_heatmap_no_robot:
                box = RobotBox(arm_links_info, env_name=env)
                robot_point_idxs = np.where(box.point_mask(xyz))[0]

            if self.augment_pc:
                angle = rng.uniform(-1, 1) * self.aug_max_rot
                xyz = random_rotate_z_np(xyz, angle)
                ee_pose[:3] = random_rotate_z_np(ee_pose[:3], angle)
                gt_action[:3] = random_rotate_z_np(gt_action[:3], angle)
                zrot = R.from_euler("z", angle)
                ee_pose[3:7] = (zrot * R.from_quat(ee_pose[3:7])).as_quat()
                gt_action[3:7] = (zrot * R.from_quat(gt_action[3:7])).as_quat()
                gt_rot = self._recompute_rot(gt_action[3:7], gt_rot)
                xyz = xyz + rng.uniform(0, 0.002, xyz.shape)

            if self.xyz_shift == "none":
                centroid = np.zeros(3, np.float32)
            elif self.xyz_shift == "center":
                centroid = xyz.mean(0)
            else:  # gripper
                centroid = ee_pose[:3].copy()
            radius = float(np.max(np.linalg.norm(xyz - centroid, axis=1))) \
                if self.xyz_norm else 1.0
            xyz = (xyz - centroid) / radius
            height = height / radius
            gt_action[:3] = (gt_action[:3] - centroid) / radius
            ee_pose[:3] = (ee_pose[:3] - centroid) / radius

            gt_out = np.concatenate(
                [gt_action[:3], np.asarray(gt_rot, np.float32).reshape(-1),
                 gt_action[-1:]], 0).astype(np.float32)
            rgb = (rgb / 255.0) * 2 - 1
            pc_ft = np.concatenate([xyz, rgb], 1)
            if self.use_height:
                pc_ft = np.concatenate([pc_ft, height[:, None]], 1)

            sample = {
                "data_id": f"{taskvar}-{episode}-t{t}",
                "pc_fts": pc_ft.astype(np.float32),
                "txt_embeds": self._instr_embed(taskvar, rng),
                "ee_poses": ee_pose.astype(np.float32),
                "gt_actions": gt_out,
                "step_ids": t,
                "pc_centroids": centroid.astype(np.float32),
                "pc_radius": np.float32(radius),
            }
            if self.pos_type == "disc":
                # only the robot-point mask: the (3, n * 2 * pos_bins)
                # targets are built on the device in the train step
                rm = np.zeros(len(xyz), bool)
                if robot_point_idxs is not None and len(robot_point_idxs):
                    rm[robot_point_idxs] = True
                sample["robot_point_mask"] = rm
            samples.append(sample)
        return samples

    def __getitem__(self, idx):
        tv, ep = self.data_ids[idx]
        return self.get_episode_samples(tv, ep)
