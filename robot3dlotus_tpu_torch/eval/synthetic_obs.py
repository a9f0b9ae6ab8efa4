"""Seeded synthetic RLBench-style observations for smoke runs and tests.

An observation has the layout robot3dlotus_tpu/eval/server.py hands the
Actioner and the 3D-LOTUS++ pipeline: per-camera (H, W, 3) xyz and rgb
images, (H, W) `gt_mask` images of simulator semantic ids, the gripper
pose (xyz, quaternion xyzw, open) and `arm_links_info` = (bbox_info,
pose_info) as RobotBox reads it. The scene is a tabletop inside the RLBench
workspace: the table plane (removed by the crop), a wall outside the
workspace, a few boxes standing on the table, the Panda arm's link boxes
beside them and points on the gripper's three links. The semantic ids are
those of the taskvar TASKVAR (assets/taskvars_target_label_zrange.json):
the first box is its object (a red cube, id 85), the second its target (a
green square, id 81); the other boxes, the gripper, the table and the wall
carry ids that name nothing in that table.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as R

TABLE_Z = 0.745   # 5 mm under the workspace crop (table height 0.7505)
ARM_LINKS = ["Panda_link0", "Panda_link1", "Panda_link2", "Panda_link3",
             "Panda_link4", "Panda_link5", "Panda_link6", "Panda_link7",
             "Panda_rightfinger", "Panda_leftfinger", "Panda_gripper"]
_VISUAL = {"Panda_link0", "Panda_rightfinger", "Panda_leftfinger",
           "Panda_gripper"}
TASKVAR = "slide_block_to_color_target_peract+0"
OBJECT_ID, TARGET_ID = 85, 81
TABLE_ID, WALL_ID, GRIPPER_ID, OTHER_ID = 1, 2, 3, 100   # OTHER_ID + box


def _box_surface(rng, n, lo, hi):
    """n points on the five faces (no bottom) of the box [lo, hi]."""
    size = hi - lo
    areas = np.array([size[0] * size[1]] + [size[1] * size[2]] * 2
                     + [size[0] * size[2]] * 2)
    face = rng.choice(5, n, p=areas / areas.sum())
    p = lo + rng.random((n, 3)) * size
    p[face == 0, 2] = hi[2]
    p[face == 1, 0] = lo[0]
    p[face == 2, 0] = hi[0]
    p[face == 3, 1] = lo[1]
    p[face == 4, 1] = hi[1]
    return p


def synthetic_observation(seed, cameras=4, height=256, width=256,
                          n_objects=8):
    rng = np.random.default_rng(seed)
    n = height * width
    boxes = []
    for _ in range(n_objects):
        c = np.array([rng.uniform(-0.1, 0.5), rng.uniform(-0.4, 0.4),
                      TABLE_Z])
        half = np.array([rng.uniform(0.03, 0.08), rng.uniform(0.03, 0.08),
                         0.0])
        top = rng.uniform(0.05, 0.2)
        boxes.append((c - half, c + half + np.array([0, 0, top]),
                      rng.uniform(0, 255, 3)))
    box_ids = [OBJECT_ID, TARGET_ID] + [OTHER_ID + b
                                        for b in range(2, n_objects)]
    links = _link_poses()
    grip = np.random.default_rng(seed + 1)   # keeps the scene's draws as is
    pcs, rgbs, sems = [], [], []
    for _ in range(cameras):
        kind = rng.choice(3, n, p=[0.3, 0.1, 0.6])   # table, wall, objects
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3))
        sem = np.full(n, TABLE_ID, np.int32)
        t = kind == 0
        xyz[t] = np.stack([rng.uniform(-0.3, 0.8, t.sum()),
                           rng.uniform(-0.6, 0.6, t.sum()),
                           np.full(t.sum(), TABLE_Z)], -1)
        rgb[t] = (120, 90, 60)
        w = kind == 1
        xyz[w] = np.stack([np.full(w.sum(), 1.6), rng.uniform(-1, 1, w.sum()),
                           rng.uniform(0.0, 2.0, w.sum())], -1)
        rgb[w] = (200, 200, 200)
        sem[w] = WALL_ID
        o = np.nonzero(kind == 2)[0]
        which = rng.integers(0, n_objects, o.size)
        for b, (lo, hi, color) in enumerate(boxes):
            sel = o[which == b]
            xyz[sel] = _box_surface(rng, sel.size, lo, hi)
            rgb[sel] = color
            sem[sel] = box_ids[b]
        xyz += rng.normal(0, 1e-3, xyz.shape)
        rgb = np.clip(rgb + rng.normal(0, 8, rgb.shape), 0, 255)
        # a tenth of the wall (cropped anyway) moves onto the gripper links
        g = np.nonzero(w)[0][::10]
        link = grip.integers(len(ARM_LINKS) - 3, len(ARM_LINKS), g.size)
        for i in np.unique(link):
            centre, rot, half = links[i]
            local = grip.uniform(-0.8, 0.8, ((link == i).sum(), 3)) * half
            xyz[g[link == i]] = centre + local @ rot.T
        rgb[g] = (60, 60, 60)
        sem[g] = GRIPPER_ID
        pcs.append(xyz.reshape(height, width, 3).astype(np.float32))
        rgbs.append(rgb.reshape(height, width, 3).astype(np.uint8))
        sems.append(sem.reshape(height, width))

    bbox_info, pose_info = {}, {}
    for link, (centre, rot, half) in zip(ARM_LINKS, links):
        kind = "visual" if link in _VISUAL else "respondable"
        # bbox in the link frame as [xmin, xmax, ymin, ymax, zmin, zmax]
        bbox_info[f"{link}_{kind}_bbox"] = np.stack([-half, half], -1).ravel()
        pose_info[f"{link}_{kind}_pose"] = np.concatenate(
            [centre, R.from_matrix(rot).as_quat()])
    gripper = np.array([0.3, 0.0, 1.1, 0.0, 1.0, 0.0, 0.0, 1.0], np.float32)
    return {"rgb": rgbs, "pc": pcs, "gt_mask": sems, "gripper": gripper,
            "arm_links_info": (bbox_info, pose_info)}


def _link_poses():
    """(centre, rotation matrix, half extent) of each arm link box: a
    column beside the table, each link turned a little more about z."""
    out = []
    for i in range(len(ARM_LINKS)):
        q = [0.0, 0.0, np.sin(0.1 * i), np.cos(0.1 * i)]
        out.append((np.array([-0.25, 0.0, TABLE_Z + 0.05 + 0.08 * i]),
                    R.from_quat(q).as_matrix(), np.array([0.05, 0.05, 0.04])))
    return out
