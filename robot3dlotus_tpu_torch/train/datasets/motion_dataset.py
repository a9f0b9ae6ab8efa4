"""Motion-planner dataset: host preprocessing for 3D-LOTUS++ training (the
port's copy of robot3dlotus_tpu/train/datasets/motion_dataset.py, numpy
and scipy only).

Per step of an episode: table crop -> robot-box removal -> point sampling
-> 4-way point labels (0 obstacle / 1 robot / 2 object / 3 target, from
the coarse or fine semantic ids of the keystep's object and target, with
an optional z-range crop) -> z-rotation + jitter augmentation -> centring
/ normalisation -> the trajectory targets (<= max_traj_len poses, the
rotation in the configured form) -> the robot-point mask the device turns
into per-step position targets. collate_motion_samples pads a batch; short
trajectories repeat their last pose and traj_masks mark the real steps.
For one seed the samples and batches are bit-equal to the JAX package's.
"""
from __future__ import annotations

import json
import zlib
from typing import Dict, List

import numpy as np
from scipy.spatial.transform import Rotation as R

from ...utils.assets import resolve_asset
from ...utils.robot_box import RobotBox
from .collate import TXT_BUCKETS, _bucket
from .keystep_dataset import KeystepDataset, random_rotate_z_np


class MotionPlannerDataset(KeystepDataset):
    """Indexable over (taskvar, episode) -> list of step samples."""

    def __init__(
        self, store, action_embed_file=None, gt_act_obj_label_file=None,
        taskvar_file=None, num_points=4096, xyz_shift="center",
        xyz_norm=False, use_height=True, max_traj_len=5,
        pc_label_type="mix", pc_label_augment=0.0, pc_midstep_augment=True,
        rot_type="euler_disc", instr_embed_type="all", rm_table=True,
        rm_robot="box_keep_gripper", include_last_step=False,
        augment_pc=True, aug_max_rot=45, same_npoints_per_example=False,
        rm_pc_outliers=False, rm_pc_outliers_neighbors=25,
        euler_resolution=5, pos_type="disc", pos_heatmap_no_robot=True,
        use_color=False, instr_include_objects=False, real_robot=False,
        txt_embed_dim=512, rng=None, **unused,
    ):
        """The TRAIN_DATASET config's keys; the instruction files of the
        policy and the keys that shape the device targets land in
        `unused`."""
        super().__init__(
            store, taskvar_file=taskvar_file, num_points=num_points,
            xyz_shift=xyz_shift, xyz_norm=xyz_norm, use_height=use_height,
            rot_type=rot_type, instr_embed_type=instr_embed_type,
            rm_table=rm_table, rm_robot=rm_robot,
            include_last_step=include_last_step, augment_pc=augment_pc,
            aug_max_rot=aug_max_rot,
            same_npoints_per_example=same_npoints_per_example,
            rm_pc_outliers=rm_pc_outliers,
            rm_pc_outliers_neighbors=rm_pc_outliers_neighbors,
            euler_resolution=euler_resolution,
            pos_type=pos_type, pos_heatmap_no_robot=pos_heatmap_no_robot,
            real_robot=real_robot, txt_embed_dim=txt_embed_dim, rng=rng)
        self.max_traj_len = max_traj_len
        self.pc_label_type = pc_label_type
        self.pc_label_augment = pc_label_augment
        self.pc_midstep_augment = pc_midstep_augment
        self.use_color = use_color
        self.instr_include_objects = instr_include_objects
        self.action_embeds = None
        if action_embed_file:
            self.action_embeds = np.load(resolve_asset(action_embed_file),
                                         allow_pickle=True).item()
            if instr_embed_type == "last":
                self.action_embeds = {k: v[-1:] for k, v in
                                      self.action_embeds.items()}
        self.gt_act_obj_labels = None
        if gt_act_obj_label_file:
            with open(resolve_asset(gt_act_obj_label_file)) as f:
                self.gt_act_obj_labels = json.load(f)

    def _action_embed(self, action_name):
        if self.action_embeds is not None and \
                action_name in self.action_embeds:
            return np.asarray(self.action_embeds[action_name], np.float32)
        # the crc32 pseudo-embedding (stable across processes)
        h = zlib.crc32(action_name.encode("utf-8")) % (2 ** 31)
        return np.random.RandomState(h).randn(
            3, self.txt_embed_dim).astype(np.float32)

    @staticmethod
    def _label_mask(gt_sem, label_ids):
        m = np.zeros(gt_sem.shape[0], bool)
        for lid in label_ids:
            m |= gt_sem == lid
        return m

    def get_episode_samples(self, taskvar, episode, rng=None) -> List[Dict]:
        data = self.store.get(taskvar, episode)
        rng = rng if rng is not None else self.rng
        obj_labels = (self.gt_act_obj_labels.get(taskvar)
                      if self.gt_act_obj_labels else None)
        env = "real" if self.real_robot else "rlbench"
        num_steps = len(data["xyz"])
        samples = []
        keystep = -1
        for t in range(num_steps):
            if data["is_new_keystep"][t]:
                keystep += 1
            if (not self.pc_midstep_augment) and \
                    (not data["is_new_keystep"][t]) and t != num_steps - 1:
                continue
            if (not self.include_last_step) and t == num_steps - 1:
                continue

            xyz = np.asarray(data["xyz"][t], np.float32)
            rgb = np.asarray(data["rgb"][t], np.float32)
            gt_sem = np.asarray(data["sem"][t])
            arm_links_info = (
                {k: np.asarray(v[t]) for k, v in data["bbox_info"].items()},
                {k: np.asarray(v[t]) for k, v in data["pose_info"].items()},
            )
            if t < num_steps - 1:
                gt_trajs = np.asarray(
                    data["trajs"][t], np.float32)[:self.max_traj_len].copy()
            else:
                gt_trajs = np.asarray(
                    data["trajs"][-2], np.float32)[-1:].copy()
            gt_traj_len = len(gt_trajs)
            ee_pose = np.asarray(data["ee_pose"][t], np.float32).copy()

            if obj_labels is not None:
                ks = obj_labels[min(keystep, len(obj_labels) - 1)]
                action_name = ks["action"]
                if self.instr_include_objects:
                    if "object" in ks:
                        action_name += f" {ks['object']['name']}"
                    if "target" in ks:
                        action_name += f" to {ks['target']['name']}"
            else:
                ks = {}
                action_name = f"move {taskvar}"
            action_embed = self._action_embed(action_name)

            if self.rm_table:
                keep = xyz[:, 2] > self.TABLE_HEIGHT
                xyz, rgb, gt_sem = xyz[keep], rgb[keep], gt_sem[keep]
            if self.rm_robot.startswith("box"):
                box = RobotBox(arm_links_info,
                               keep_gripper=self.rm_robot == "box_keep_gripper",
                               env_name=env)
                keep = ~box.point_mask(xyz)
                xyz, rgb, gt_sem = xyz[keep], rgb[keep], gt_sem[keep]
            if len(xyz) == 0:
                continue

            if len(xyz) > self.num_points:
                idxs = rng.permutation(len(xyz))[:self.num_points]
            elif self.same_npoints_per_example:
                idxs = rng.choice(len(xyz), self.num_points, replace=True)
            else:
                maxn = int(len(xyz) * rng.uniform(0.95, 1))
                idxs = rng.permutation(len(xyz))[:max(maxn, 1)]
            xyz, rgb, gt_sem = xyz[idxs], rgb[idxs], gt_sem[idxs]
            height = xyz[:, 2] - self.TABLE_HEIGHT

            box = RobotBox(arm_links_info, keep_gripper=False, env_name=env)
            robot_mask = box.point_mask(xyz)
            robot_point_idxs = np.where(robot_mask)[0]
            pc_label = np.zeros(xyz.shape[0], np.int32)
            pc_label[robot_mask] = 1
            for oname, lid in (("object", 2), ("target", 3)):
                if oname in ks:
                    v = ks[oname]
                    key = (self.pc_label_type if self.pc_label_type != "mix"
                           else ("coarse", "fine")[int(rng.randint(2))])
                    obj_mask = self._label_mask(gt_sem, v[key])
                    if "zrange" in v:
                        obj_mask &= (xyz[:, 2] > v["zrange"][0]) & \
                            (xyz[:, 2] < v["zrange"][1])
                    if self.pc_label_augment > 0:
                        cand = np.where(obj_mask)[0]
                        rm = int(rng.uniform(0, self.pc_label_augment) *
                                 len(cand))
                        obj_mask[rng.permutation(cand)[:rm]] = False
                    pc_label[obj_mask] = lid

            if self.augment_pc:
                angle = rng.uniform(-1, 1) * self.aug_max_rot
                xyz = random_rotate_z_np(xyz, angle)
                ee_pose[:3] = random_rotate_z_np(ee_pose[:3], angle)
                zrot = R.from_euler("z", angle)
                ee_pose[3:7] = (zrot * R.from_quat(ee_pose[3:7])).as_quat()
                for i in range(len(gt_trajs)):
                    gt_trajs[i, :3] = random_rotate_z_np(gt_trajs[i, :3],
                                                         angle)
                    gt_trajs[i, 3:7] = (
                        zrot * R.from_quat(gt_trajs[i, 3:7])).as_quat()
                xyz = xyz + rng.uniform(0, 0.002, xyz.shape)

            gt_rots = np.stack(
                [self._recompute_rot(a[3:7], a[3:7]) for a in gt_trajs], 0)

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
            gt_trajs[:, :3] = (gt_trajs[:, :3] - centroid) / radius
            ee_pose[:3] = (ee_pose[:3] - centroid) / radius

            gt_out = np.concatenate(
                [gt_trajs[:, :3], gt_rots.astype(np.float32),
                 gt_trajs[:, -1:]], -1).astype(np.float32)

            pc_ft = xyz
            if self.use_height:
                pc_ft = np.concatenate([pc_ft, height[:, None]], 1)
            if self.use_color:
                pc_ft = np.concatenate([pc_ft, (rgb / 255.0) * 2 - 1], 1)

            sample = {
                "data_id": f"{taskvar}-{episode}-t{t}",
                "pc_fts": pc_ft.astype(np.float32),
                "pc_labels": pc_label,
                "txt_embeds": action_embed,
                "ee_poses": ee_pose,
                "gt_trajs": gt_out,
                "gt_traj_len": gt_traj_len,
                "step_ids": t,
                "pc_centroids": centroid.astype(np.float32),
                "pc_radius": np.float32(radius),
            }
            if self.pos_type == "disc":
                # only the robot-point mask: the per-step position targets
                # are built on the device in the train step
                rm = np.zeros(len(xyz), bool)
                if self.pos_heatmap_no_robot and len(robot_point_idxs):
                    rm[robot_point_idxs] = True
                sample["robot_point_mask"] = rm
            samples.append(sample)
        return samples


def collate_motion_samples(samples, num_points, max_traj_len,
                           num_clouds=None, txt_buckets=TXT_BUCKETS):
    """Fixed-shape motion-planner batch: short batches repeat the last
    sample (batch_valid marks the real ones), short trajectories repeat
    their last pose (traj_masks marks the real steps), and the stop target
    is 1 from each trajectory's last step on."""
    B = num_clouds or len(samples)
    batch_valid = np.zeros(B, bool)
    batch_valid[:min(len(samples), B)] = True
    samples = (samples + [samples[-1]] * max(0, B - len(samples)))[:B]
    N, L = num_points, max_traj_len
    cin = samples[0]["pc_fts"].shape[-1]
    T = _bucket(max(s["txt_embeds"].shape[0] for s in samples), txt_buckets)
    td = samples[0]["txt_embeds"].shape[-1]

    pc = np.zeros((B, N, cin), np.float32)
    labels = np.zeros((B, N), np.int32)
    mask = np.zeros((B, N), bool)
    counts = np.zeros(B, np.int32)
    txt = np.zeros((B, T, td), np.float32)
    txt_mask = np.zeros((B, T), bool)
    ee = np.zeros((B, 8), np.float32)
    rdim = samples[0]["gt_trajs"].shape[-1]
    trajs = np.zeros((B, L, rdim), np.float32)
    stops = np.zeros((B, L), np.float32)
    tmask = np.zeros((B, L), bool)
    centroids = np.zeros((B, 3), np.float32)
    radius = np.zeros(B, np.float32)
    has_rm = "robot_point_mask" in samples[0]
    robot_mask = np.zeros((B, N), bool) if has_rm else None

    for i, s in enumerate(samples):
        n = min(s["pc_fts"].shape[0], N)
        pc[i, :n] = s["pc_fts"][:n]
        labels[i, :n] = s["pc_labels"][:n]
        mask[i, :n] = True
        counts[i] = n
        t = min(s["txt_embeds"].shape[0], T)
        txt[i, :t] = s["txt_embeds"][:t]
        txt_mask[i, :t] = True
        ee[i] = s["ee_poses"][:8]
        L_t = min(s["gt_trajs"].shape[0], L)
        trajs[i, :L_t] = s["gt_trajs"][:L_t]
        trajs[i, L_t:] = s["gt_trajs"][L_t - 1]
        gl = min(s["gt_traj_len"], L)
        stops[i] = (np.arange(L) >= gl - 1).astype(np.float32)
        tmask[i, :L_t] = True
        centroids[i] = s["pc_centroids"]
        radius[i] = s["pc_radius"]
        if has_rm:
            robot_mask[i, :n] = s["robot_point_mask"][:n]

    out = {
        "pc_fts": pc, "pc_labels": labels, "pc_mask": mask,
        "pc_counts": counts, "txt_embeds": txt, "txt_mask": txt_mask,
        "ee_poses": ee, "gt_trajs": trajs, "gt_trajs_stop": stops,
        "traj_masks": tmask, "step_ids": np.zeros(B, np.int32),
        "batch_valid": batch_valid,
        "pc_centroids": centroids, "pc_radius": radius,
    }
    if has_rm:
        out["pc_robot_mask"] = robot_mask
    return out
