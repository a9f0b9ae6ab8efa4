"""Oriented-bounding-box robot-arm point removal, open3d-free: the PyTorch
port's copy of robot3dlotus_tpu/utils/robot_box.py (host numpy code).

Upstream: genrobo3d/utils/robot_box.py (o3d.geometry.OrientedBoundingBox per
arm link). Same semantics: box center = link pose position, orientation =
link quaternion, extent = bbox max-min per axis; a point is inside iff its
coordinates in the box frame are within extent/2 on every axis.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as R

RLBENCH_ARM_LINKS = [
    "Panda_link0", "Panda_link1", "Panda_link2", "Panda_link3",
    "Panda_link4", "Panda_link5", "Panda_link6", "Panda_link7",
]
RLBENCH_GRIPPER_LINKS = ["Panda_rightfinger", "Panda_leftfinger", "Panda_gripper"]
_VISUAL_LINKS = {"Panda_link0", "Panda_rightfinger", "Panda_leftfinger",
                 "Panda_gripper"}


class RobotBox:
    def __init__(self, arm_links_info, env_name="rlbench", keep_gripper=False):
        bbox_info, pose_info = arm_links_info
        self.boxes = []  # list of (center(3), rot(3,3), extent(3))

        if env_name == "rlbench":
            links = list(RLBENCH_ARM_LINKS)
            if not keep_gripper:
                links.extend(RLBENCH_GRIPPER_LINKS)
            for link in links:
                kind = "visual" if link in _VISUAL_LINKS else "respondable"
                bbox = np.asarray(bbox_info[f"{link}_{kind}_bbox"], np.float64)
                pose = np.asarray(pose_info[f"{link}_{kind}_pose"], np.float64)
                self._add_box(pose, bbox)
        elif env_name == "real":
            rm = {
                "left_base_link_bbox", "left_shoulder_link_bbox",
                "left_upper_arm_link_bbox", "left_forearm_link_bbox",
                "left_wrist_1_link_bbox", "left_wrist_2_link_bbox",
                "left_wrist_3_link_bbox", "left_ft300_mounting_plate_bbox",
                "left_ft300_sensor_bbox",
            }
            if not keep_gripper:
                rm |= {
                    "left_camera_link_bbox", "left_gripper_body_bbox",
                    "left_gripper_bracket_bbox",
                    "left_gripper_finger_1_finger_tip_bbox",
                    "left_gripper_finger_1_flex_finger_bbox",
                    "left_gripper_finger_1_safety_shield_bbox",
                    "left_gripper_finger_1_truss_arm_bbox",
                    "left_gripper_finger_1_moment_arm_bbox",
                    "left_gripper_finger_2_finger_tip_bbox",
                    "left_gripper_finger_2_flex_finger_bbox",
                    "left_gripper_finger_2_safety_shield_bbox",
                    "left_gripper_finger_2_truss_arm_bbox",
                    "left_gripper_finger_2_moment_arm_bbox",
                }
            for name, bbox in bbox_info.items():
                if name in rm:
                    pose = np.asarray(
                        pose_info[name.replace("_bbox", "_pose")], np.float64)
                    self._add_box(pose, np.asarray(bbox, np.float64))
        else:
            raise ValueError(env_name)

    def _add_box(self, pose, bbox):
        # copy: zero-copy msgpack/LMDB arrays are read-only and scipy's
        # Rotation rejects non-writable buffers
        pose = np.array(pose, np.float64)
        rot = R.from_quat(pose[3:7]).as_matrix()
        extent = np.asarray(bbox[1::2]) - np.asarray(bbox[::2])
        self.boxes.append((pose[:3], rot, extent))
        self._stacked = None

    def _stack(self):
        # fold all K link boxes into ONE (3, 3K) rotation matrix plus a
        # (3K,) offset so point_mask is a single BLAS gemm instead of a
        # Python loop per box: (p - c_k) @ R_k == p @ R_k - c_k @ R_k
        # (this runs per sample in the training-data hot path)
        if self._stacked is None:
            k = len(self.boxes)
            rot_cat = np.concatenate([b[1] for b in self.boxes], axis=1)
            off = np.concatenate(
                [b[0] @ b[1] for b in self.boxes])          # (3K,)
            half = np.concatenate(
                [b[2] / 2 + 1e-12 for b in self.boxes])     # (3K,)
            # world-frame AABB of the box union for the cheap prefilter:
            # |p - c|_i <= (|R| h)_i bounds every point of an OBB, so the
            # union AABB is a strict superset — filtering with it is exact
            whalf = [np.abs(b[1]) @ (b[2] / 2 + 1e-12) for b in self.boxes]
            lo = np.min([b[0] - w for b, w in zip(self.boxes, whalf)], 0)
            hi = np.max([b[0] + w for b, w in zip(self.boxes, whalf)], 0)
            self._stacked = (rot_cat, off, half, k, lo, hi)
        return self._stacked

    def point_mask(self, xyz):
        """(N, 3) -> bool mask, True where a point is inside ANY link box."""
        xyz = np.asarray(xyz, np.float64)
        if not self.boxes:
            return np.zeros(xyz.shape[0], dtype=bool)
        rot_cat, off, half, k, lo, hi = self._stack()
        # prefilter: only points inside the union's world AABB can be
        # inside any OBB — in workspace clouds that is a small fraction,
        # so the (N, 3K) gemm runs on ~10x fewer rows
        cand = ((xyz >= lo) & (xyz <= hi)).all(-1)
        idx = np.nonzero(cand)[0]
        mask = np.zeros(len(xyz), dtype=bool)
        if idx.size:
            local = xyz[idx] @ rot_cat - off                 # (n_cand, 3K)
            inside = np.abs(local) <= half
            mask[idx] = inside.reshape(idx.size, k, 3).all(-1).any(-1)
        return mask

    def get_pc_overlap_ratio(self, xyz=None, return_indices=False):
        inside = self.point_mask(xyz)
        ratio = inside.sum() / max(len(inside), 1)
        if return_indices:
            return ratio, set(np.where(inside)[0].tolist())
        return ratio
