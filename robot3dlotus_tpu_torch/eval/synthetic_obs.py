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


class ScriptedVLMBackend:
    """Stand-ins for the OWLv2 detector and the SAM segmenter, scripted
    from the semantic masks of registered observations (their weights
    are not in the repository). `register(obs)` files each camera's
    semantic image under a hash of its rgb image; then

      encode_images(images): per image, one patch per semantic id present
        (sorted), its slot j in a row of SLOTS small boxes (centre
        ((j + 0.5) / SLOTS, 0.5), side 0.5 / SLOTS, so they never
        overlap), an objectness logit from the id and the view, and a
        class embedding that is the id's seeded unit vector plus a little
        per-view noise; every other patch scores far below the threshold;
      encode_texts(texts): the id's vector for a text that names it in
        `names` ({semantic id: name}), else a seeded vector of the text;
      __call__(images, boxes): per box SAM's three masks, the id's
        semantic mask at position j % 3 (the best score) and two decoys.

    Grounding a named object then finds it, and the boxes of the table,
    the wall and the gripper exercise the pipeline's cleaning."""

    SLOTS = 16
    sqrt_num_patches = 16

    def __init__(self, names, embed_dim=32, seed=0):
        self.names = dict(names)
        self.embed_dim, self.seed = embed_dim, seed
        self.views = {}

    @staticmethod
    def _key(img):
        import zlib
        return zlib.crc32(np.ascontiguousarray(img).tobytes())

    def register(self, obs):
        for rgb, sem in zip(obs["rgb"], obs["gt_mask"]):
            self.views[self._key(rgb)] = np.asarray(sem)

    def _vec(self, *key):
        """A seeded unit vector for the key."""
        v = np.random.default_rng((self.seed,) + key).normal(
            size=self.embed_dim)
        return v / np.linalg.norm(v)

    def _ids(self, img):
        return [int(i) for i in np.unique(self.views[self._key(img)])]

    def encode_images(self, images):
        B, P, D = len(images), self.sqrt_num_patches ** 2, self.embed_dim
        logits = np.full((B, P), -8.0, np.float32)
        boxes = np.tile(np.array([0.5, 0.9, 0.02, 0.02], np.float32),
                        (B, P, 1))
        embeds = np.stack([np.stack([self._vec(1000 + v, p)
                                     for p in range(P)])
                           for v in range(B)]).astype(np.float32)
        for v, img in enumerate(images):
            for j, i in enumerate(self._ids(img)):
                logits[v, j] = 2.0 + 0.1 * ((i * 7 + v) % 11)
                boxes[v, j] = [(j + 0.5) / self.SLOTS, 0.5,
                               0.5 / self.SLOTS, 0.5 / self.SLOTS]
                e = self._vec(i) + 0.05 * self._vec(2000 + v, i)
                embeds[v, j] = e / np.linalg.norm(e)
        return {"image_embeds": embeds, "pred_boxes": boxes,
                "objectness_logits": logits, "image_class_embeds": embeds,
                "class_logit_shift": np.zeros((B, P, 1), np.float32),
                "class_logit_scale": np.ones((B, P, 1), np.float32)}

    def encode_texts(self, texts):
        out = []
        for t in texts:
            hit = [i for i, n in self.names.items() if n in t]
            out.append(self._vec(hit[0]) if hit else
                       self._vec(3000, self._key(np.frombuffer(
                           t.encode("utf-8"), np.uint8))))
        return {"text_embeds": np.stack(out).astype(np.float32)}

    def __call__(self, images, boxes):
        out = []
        for img, bxs in zip(images, boxes):
            if len(bxs) == 0:
                out.append(None)
                continue
            sem = self.views[self._key(img)]
            ids = self._ids(img)
            scores, masks = [], []
            for b in bxs:
                j = int((b[0] + b[2]) / 2 / max(sem.shape) * self.SLOTS)
                m = sem == ids[j]
                decoys = [m & (np.arange(m.shape[1]) % 2 == 0),
                          np.zeros_like(m)]
                masks.append(np.stack(decoys[:j % 3] + [m] +
                                      decoys[j % 3:]))
                s = np.full(3, 0.3)
                s[j % 3] = 0.9
                scores.append(s)
            out.append({"scores": np.stack(scores),
                        "masks": np.stack(masks)})
        return out
