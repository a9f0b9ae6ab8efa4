"""3D-LOTUS++ with the ground-truth task planner and ground-truth vision
(the port's copy of the GT path of robot3dlotus_tpu/eval/robot_pipeline.py):
the configuration GemBench users run to isolate the learned motion planner
(configs/rlbench/robot_pipeline_gt.yaml).

Per environment step GroundtruthRobotPipeline.predict:
  1. on step 0, takes the taskvar's plan from the in-context examples
     (GroundtruthTaskPlanner) and parses it into primitives (parse_code);
  2. replays the cached trajectory steps of the last motion-planner call;
  3. answers a 'release' step by opening the gripper;
  4. labels every point 0 obstacle / 1 robot / 2 object / 3 target from
     the simulator's semantic masks (GroundtruthVision) and normalises the
     cloud;
  5. runs the motion planner on the card (MotionPlannerEngine.predict: the
     model forward and decode_mp_actions, a (5, 9) trajectory) and executes
     up to run_action_step steps of it, advancing the plan when the stop
     bit fires.

Action-name embeddings come from a cache file when it holds the name, else
from the crc32 pseudo-embedding of the synthetic training store; on-demand
CLIP encoding, the LLM planner and the VLM grounding are not ported.
"""
from __future__ import annotations

import copy
import json
import os
import zlib
from typing import Dict

import numpy as np
import torch

from ..configs import get_config
from ..configs.rlbench.constants import get_robot_workspace
from ..models.factory import build_model, resolve_device
from ..models.motion_planner import decode_mp_actions
from ..ops.voxel import voxelize_pcd_np, workspace_mask_np
from ..train.checkpoint import load_any_model_ckpt
from ..utils.assets import resolve_asset
from ..utils.robot_box import RobotBox
from ..vlm.llm_planner import GroundtruthTaskPlanner
from .actioner import TXT_BUCKETS, _bucket
from .common import parse_code


class ActionTextEmbedder:
    """Action name -> per-token text embedding (T, txt_embed_dim), cached:
    from the .npy cache file when it holds the name, else the crc32
    pseudo-embedding (3 tokens) that the synthetic stores train on."""

    def __init__(self, action_embed_file=None, txt_embed_dim=512):
        self.txt_embed_dim = txt_embed_dim
        self.cache: Dict[str, np.ndarray] = {}
        action_embed_file = resolve_asset(action_embed_file)
        if action_embed_file and os.path.exists(action_embed_file):
            self.cache.update(
                np.load(action_embed_file, allow_pickle=True).item())

    def __call__(self, action_name: str) -> np.ndarray:
        if action_name not in self.cache:
            h = zlib.crc32(action_name.encode("utf-8")) % (2 ** 31)
            self.cache[action_name] = np.random.RandomState(h).randn(
                3, self.txt_embed_dim).astype(np.float32)
        return np.asarray(self.cache[action_name], np.float32)


class MotionPlannerEngine:
    """The motion planner of a train config (either class, CA or AdaNorm,
    through the factory), served one cloud at a time on `device`: pad to
    num_points, forward, decode, then un-normalise on the host. Weights
    come from `checkpoint` (a .msgpack of either package or
    an upstream-layout .pt, as the Actioner loads them), or are a seeded
    init without one."""

    def __init__(self, config_file, checkpoint=None, cli_opts=None,
                 device="cuda", seed=0):
        self.device = resolve_device(device)
        self.config = get_config(config_file, cli_opts)
        self.data_cfg = dict(self.config.TRAIN_DATASET)
        self.act_cfg = dict(self.config.MODEL.action_config)
        self.num_points = int(self.data_cfg.get("num_points", 4096))
        self.model = build_model(self.config.MODEL, device=self.device,
                                 seed=seed)
        if checkpoint:
            self.model.load_state_dict(load_any_model_ckpt(
                checkpoint, self.model, self.config.MODEL), strict=True)

    def _batch(self, pc_ft, pc_label, txt_embed, ee_pose=None):
        """Host arrays -> a B = 1 device batch, padded to num_points points
        and a text bucket, with the gripper pose (zeros without one) for
        the pose token; one transfer per array."""
        N = self.num_points
        n = min(len(pc_ft), N)
        pc = np.zeros((1, N, pc_ft.shape[-1]), np.float32)
        pc[0, :n] = pc_ft[:n]
        labels = np.zeros((1, N), np.int64)
        labels[0, :n] = pc_label[:n]
        mask = np.zeros((1, N), bool)
        mask[0, :n] = True
        T = _bucket(txt_embed.shape[0], TXT_BUCKETS)
        t = min(txt_embed.shape[0], T)
        txt = np.zeros((1, T, txt_embed.shape[-1]), np.float32)
        txt[0, :t] = txt_embed[:t]
        txt_mask = np.zeros((1, T), bool)
        txt_mask[0, :t] = True
        ee = np.zeros((1, 8), np.float32)
        if ee_pose is not None:
            ee[0] = ee_pose
        to = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        return {"pc_fts": to(pc), "pc_labels": to(labels),
                "pc_mask": to(mask), "pc_counts": to(np.array([n])),
                "txt_embeds": to(txt), "txt_mask": to(txt_mask),
                "ee_poses": to(ee)}

    @torch.inference_mode()
    def forward(self, batch):
        """Device batch -> (B, L, 9) decoded trajectories on the host."""
        preds = self.model(batch)
        return decode_mp_actions(preds, self.act_cfg).cpu().numpy()

    def predict(self, pc_ft, pc_label, txt_embed, ee_pose, pc_centroid,
                pc_radius, table_height):
        """-> (L, 9) [pos(3) quat(4) open stop]: un-normalised, open and
        stop as probabilities, z clamped above the table. ee_pose feeds
        only the pose token (use_ee_pose)."""
        batch = self._batch(np.asarray(pc_ft, np.float32),
                            np.asarray(pc_label),
                            np.asarray(txt_embed, np.float32),
                            np.asarray(ee_pose, np.float32))
        actions = self.forward(batch)[0]
        actions[:, 7:] = 1.0 / (1.0 + np.exp(-actions[:, 7:]))
        actions[:, :3] = actions[:, :3] * pc_radius + pc_centroid
        actions[:, 2] = np.maximum(actions[:, 2], table_height + 0.005)
        return actions


def normalize_pcd(pcd_xyz, gripper_pose, xyz_shift="center", xyz_norm=False):
    """Centre (and optionally scale) the cloud and the gripper position."""
    if xyz_shift == "none":
        pc_centroid = np.zeros(3)
    elif xyz_shift == "center":
        pc_centroid = np.mean(pcd_xyz, 0)
    else:  # gripper
        pc_centroid = copy.deepcopy(gripper_pose[:3])
    if xyz_norm:
        pc_radius = float(np.max(np.sqrt(
            np.sum((pcd_xyz - pc_centroid) ** 2, axis=1))))
    else:
        pc_radius = 1.0
    pcd_xyz = (pcd_xyz - pc_centroid) / pc_radius
    gripper_pose = np.asarray(gripper_pose, np.float32).copy()
    gripper_pose[:3] = (gripper_pose[:3] - pc_centroid) / pc_radius
    return pcd_xyz, gripper_pose, pc_centroid, pc_radius


def sample_points(n_total, num_points, same_npoints_per_example, rng):
    if n_total > num_points:
        return rng.permutation(n_total)[:num_points]
    if same_npoints_per_example:
        return rng.choice(n_total, num_points, replace=True)
    return np.arange(n_total)


class GroundtruthVision:
    """Simulator semantic masks -> 4-way point labels and the normalised
    motion-planner inputs: workspace crop (table removed), 1 cm voxels,
    robot-box removal, sampling to num_points (from `rng`), then robot
    points 1, the keystep's object ids 2 and target ids 3 (within their
    z-range)."""

    def __init__(self, gt_label_file, num_points=4096, voxel_size=0.01,
                 same_npoints_per_example=False, rm_robot="box_keep_gripper",
                 xyz_shift="center", xyz_norm=False, use_height=True,
                 pc_label_type="coarse", use_color=False, rng=None):
        with open(resolve_asset(gt_label_file)) as f:
            self.taskvar_gt_target_labels = json.load(f)
        self.workspace = get_robot_workspace(real_robot=False)
        self.TABLE_HEIGHT = self.workspace["TABLE_HEIGHT"]
        self.num_points = num_points
        self.voxel_size = voxel_size
        self.pc_label_type = pc_label_type
        self.same_npoints_per_example = same_npoints_per_example
        self.rm_robot = rm_robot
        self.xyz_shift = xyz_shift
        self.xyz_norm = xyz_norm
        self.use_height = use_height
        self.use_color = use_color
        self.rng = rng or np.random.RandomState()

    def __call__(self, taskvar, step_id, pcd_images, sem_images, gripper_pose,
                 arm_links_info, rgb_images=None):
        pcd_xyz = np.asarray(pcd_images).reshape(-1, 3)
        pcd_sem = np.asarray(sem_images).reshape(-1)
        pcd_rgb = (np.asarray(rgb_images).reshape(-1, 3)
                   if self.use_color else None)

        fg = workspace_mask_np(pcd_xyz, self.workspace, rm_table=True)
        pcd_xyz, pcd_sem = pcd_xyz[fg], pcd_sem[fg]
        if pcd_rgb is not None:
            pcd_rgb = pcd_rgb[fg]

        pcd_xyz, idxs = voxelize_pcd_np(pcd_xyz, self.voxel_size)
        pcd_sem = pcd_sem[idxs]
        if pcd_rgb is not None:
            pcd_rgb = pcd_rgb[idxs]

        if self.rm_robot != "none":
            box = RobotBox(arm_links_info,
                           keep_gripper=self.rm_robot == "box_keep_gripper")
            keep = ~box.point_mask(pcd_xyz)
            pcd_xyz, pcd_sem = pcd_xyz[keep], pcd_sem[keep]
            if pcd_rgb is not None:
                pcd_rgb = pcd_rgb[keep]

        if len(pcd_xyz) <= 10:
            return None  # emptied cloud: the caller emits the zero action
        point_idxs = sample_points(
            len(pcd_xyz), self.num_points, self.same_npoints_per_example,
            self.rng)
        pcd_xyz, pcd_sem = pcd_xyz[point_idxs], pcd_sem[point_idxs]
        height = pcd_xyz[:, 2] - self.TABLE_HEIGHT
        if pcd_rgb is not None:
            pcd_rgb = pcd_rgb[point_idxs]

        pcd_label = np.zeros(len(pcd_xyz), np.int32)
        full_box = RobotBox(arm_links_info, keep_gripper=False)
        pcd_label[full_box.point_mask(pcd_xyz)] = 1
        step_labels = self.taskvar_gt_target_labels[taskvar][step_id]
        for query_key, label_id in zip(["object", "target"], [2, 3]):
            if query_key not in step_labels:
                continue
            gt = step_labels[query_key]
            qmask = np.zeros(len(pcd_sem), bool)
            for x in gt[self.pc_label_type]:
                qmask |= pcd_sem == x
            if "zrange" in gt:
                qmask &= (pcd_xyz[:, 2] > gt["zrange"][0]) & \
                    (pcd_xyz[:, 2] < gt["zrange"][1])
            pcd_label[qmask] = label_id

        pcd_xyz, gripper_pose, pc_centroid, pc_radius = normalize_pcd(
            pcd_xyz, gripper_pose, self.xyz_shift, self.xyz_norm)
        pcd_ft = pcd_xyz
        if self.use_height:
            pcd_ft = np.concatenate([pcd_ft, height[:, None]], -1)
        if pcd_rgb is not None:
            pcd_ft = np.concatenate([pcd_ft, (pcd_rgb / 255.0) * 2 - 1], -1)
        return {
            "pc_fts": pcd_ft.astype(np.float32), "pc_labels": pcd_label,
            "pc_centroids": pc_centroid, "pc_radius": pc_radius,
            "ee_poses": gripper_pose,
        }


def _plan_action_name(plan, instr_include_objects=False):
    """The action-name text of a plan step, embedded for the planner."""
    action_name = plan["action"]
    if plan["target"] in ("up", "down", "out", "in"):
        action_name = action_name + " " + plan["target"]
    if instr_include_objects:
        if plan.get("object"):
            obj = "".join(c for c in plan["object"] if not c.isdigit())
            action_name = f"{action_name} {obj.replace('_', ' ').strip()}"
        if plan.get("target") and plan["target"] not in (
                "up", "down", "out", "in"):
            tgt = "".join(c for c in plan["target"] if not c.isdigit())
            action_name = f"{action_name} to {tgt.replace('_', ' ').strip()}"
    return action_name


def _new_episode_cache(gripper_pose):
    return {
        "valid_actions": [], "highlevel_plans": [], "highlevel_step_id": 0,
        "highlevel_step_id_norelease": 0, "ret_objs": {},
        "grasped_obj_name": None,
        "prev_ee_pose": np.asarray(gripper_pose, np.float32).copy(),
    }


class GroundtruthRobotPipeline:
    """GT planner + GT vision + the learned motion planner. The episode
    state (`cache`) is a plain picklable dict the caller hands back on the
    next step."""

    def __init__(self, config, motion_planner: MotionPlannerEngine = None,
                 text_embedder: ActionTextEmbedder = None, device="cuda"):
        self.config = config
        self.llm_planner = GroundtruthTaskPlanner(
            resolve_asset(config["llm_planner"]["gt_plan_file"]))
        mp_cfg = config["motion_planner"]
        self.motion_planner = motion_planner or MotionPlannerEngine(
            mp_cfg["config_file"], mp_cfg.get("checkpoint"), device=device)
        data_cfg = self.motion_planner.data_cfg
        self.instr_include_objects = data_cfg.get(
            "instr_include_objects", False)
        pc_label_type = mp_cfg.get("pc_label_type") or data_cfg.get(
            "pc_label_type", "coarse")
        self.vision = GroundtruthVision(
            config["object_grounding"]["gt_label_file"],
            num_points=int(data_cfg.get("num_points", 4096)),
            voxel_size=self.motion_planner.act_cfg.get("voxel_size", 0.01),
            same_npoints_per_example=data_cfg.get(
                "same_npoints_per_example", False),
            rm_robot=data_cfg.get("rm_robot", "box_keep_gripper"),
            xyz_shift=data_cfg.get("xyz_shift", "center"),
            xyz_norm=data_cfg.get("xyz_norm", False),
            use_height=data_cfg.get("use_height", True),
            pc_label_type=pc_label_type,
            use_color=data_cfg.get("use_color", False))
        self.text_embedder = text_embedder or ActionTextEmbedder(
            mp_cfg.get("action_embed_file"))
        self.run_action_step = int(mp_cfg.get("run_action_step", 1))
        self.restart = bool(config.get("pipeline", {}).get("restart", False))
        if mp_cfg.get("save_obs_outs"):
            raise NotImplementedError("motion_planner.save_obs_outs: saving "
                                      "observations is not ported")

    def predict(self, task_str=None, variation=None, step_id=0,
                obs_state_dict=None, episode_id=None, instructions=None,
                cache=None):
        taskvar = f"{task_str}+{variation}"
        obs = obs_state_dict
        gripper_pose = copy.deepcopy(np.asarray(obs["gripper"]))

        if step_id == 0:
            cache = _new_episode_cache(gripper_pose)
            cache["highlevel_plans"] = [
                parse_code(x) for x in self.llm_planner(taskvar)]

        if cache["valid_actions"]:
            cur = np.asarray(cache["valid_actions"][0][:8])
            cache["valid_actions"] = cache["valid_actions"][1:]
            return {"action": cur, "cache": cache}

        if cache["highlevel_step_id"] >= len(cache["highlevel_plans"]):
            if not self.restart:
                return {"action": np.zeros(8), "cache": cache}
            cache["highlevel_step_id"] = 0
            cache["highlevel_step_id_norelease"] = 0

        plan = cache["highlevel_plans"][cache["highlevel_step_id"]]
        if plan is None:
            return {"action": np.zeros(8), "cache": cache}

        if plan["action"] == "release":
            action = gripper_pose.copy()
            action[7] = 1
            cache["highlevel_step_id"] += 1
            return {"action": action, "cache": cache}

        inputs = self.vision(
            taskvar, cache["highlevel_step_id_norelease"],
            obs["pc"], obs["gt_mask"], gripper_pose,
            obs["arm_links_info"], rgb_images=obs.get("rgb"))
        if inputs is None:
            return {"action": np.zeros(8), "cache": cache}

        txt_embed = self.text_embedder(
            _plan_action_name(plan, self.instr_include_objects))
        pred_actions = self.motion_planner.predict(
            inputs["pc_fts"], inputs["pc_labels"], txt_embed,
            inputs["ee_poses"], inputs["pc_centroids"], inputs["pc_radius"],
            self.vision.TABLE_HEIGHT)

        valid_actions = []
        for t, a in enumerate(pred_actions):
            valid_actions.append(a)
            if t + 1 >= self.run_action_step or a[-1] > 0.5:
                break
        if valid_actions[-1][-1] > 0.5:
            cache["highlevel_step_id"] += 1
            cache["highlevel_step_id_norelease"] += 1
        cache["valid_actions"] = [np.asarray(a) for a in valid_actions[1:]]
        return {"action": np.asarray(valid_actions[0][:8]), "cache": cache}
