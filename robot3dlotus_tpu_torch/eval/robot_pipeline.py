"""The 3D-LOTUS++ closed-loop pipelines (the port's copy of
robot3dlotus_tpu/eval/robot_pipeline.py).

RobotPipeline is the released system (configs/rlbench/robot_pipeline.yaml):
a task planner (the ground-truth plans, or LLMTaskPlanner), VLM object
grounding (vlm/pipeline.py's VLMPipeline: OWLv2 boxes, SAM masks, cleaned
and merged across views) and the learned motion planner. Per step it
plans at step 0, replays cached trajectory steps (moving a grasped
object's remembered cloud with them), answers 'release' by opening the
gripper, grounds the plan's object (label 2) and target (label 3; a target
variable is matched to a remembered cloud by chamfer distance), crops a
drawer's or a safe's level by its estimated height range, voxelizes,
removes the robot's boxes, samples num_points from its seeded RandomState,
normalises, and runs the motion planner on the card.

GroundtruthRobotPipeline (configs/rlbench/robot_pipeline_gt.yaml) isolates
the motion planner: ground-truth plans and ground-truth vision. Per
environment step GroundtruthRobotPipeline.predict:
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

Both write each step's observation and actions under
pred_dir/obs_outs/<taskvar>/<episode> with motion_planner.save_obs_outs.
Action-name embeddings come from a cache file when it holds the name, else
from the crc32 pseudo-embedding of the synthetic training store; on-demand
CLIP encoding is not ported (CLIP's weights are not in the repository).
"""
from __future__ import annotations

import copy
import json
import os
import zlib
from typing import Dict

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from ..configs import get_config
from ..configs.rlbench.constants import get_robot_workspace
from ..models.factory import build_model, resolve_device
from ..models.motion_planner import decode_mp_actions
from ..ops.chamfer import chamfer_distance_np
from ..ops.voxel import voxelize_pcd_np, workspace_mask_np
from ..train.checkpoint import load_any_model_ckpt
from ..utils.assets import resolve_asset
from ..utils.robot_box import RobotBox
from ..vlm.llm_planner import GroundtruthTaskPlanner, heuristic_height_range
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


def _new_episode_cache(gripper_pose, episode_outdir=None):
    return {
        "valid_actions": [], "highlevel_plans": [], "highlevel_step_id": 0,
        "highlevel_step_id_norelease": 0, "ret_objs": {},
        "grasped_obj_name": None,
        "prev_ee_pose": np.asarray(gripper_pose, np.float32).copy(),
        "episode_outdir": episode_outdir,
    }


def _episode_outdir(pred_dir, save_obs_outs, taskvar, episode_id):
    """pred_dir/obs_outs/<taskvar>/<episode_id> (made), or None."""
    if not (save_obs_outs and pred_dir):
        return None
    outdir = os.path.join(pred_dir, "obs_outs", taskvar, str(episode_id))
    os.makedirs(outdir, exist_ok=True)
    return outdir


def _move_grasped_obj_xyz(cur_action, prev_pose, obj_xyz):
    """Moves the grasped object's remembered cloud with the commanded
    motion, in place. As upstream: the relative rotation is the
    difference of the Euler angles, applied about the world origin after
    the translation, so it is exact only for pure translations, which the
    benchmark's move-grasped plans almost always are."""
    translation = cur_action[:3] - prev_pose[:3]
    rotation = R.from_quat(cur_action[3:7]).as_euler("xyz") - \
        R.from_quat(prev_pose[3:7]).as_euler("xyz")
    obj_xyz += translation
    obj_xyz[:] = R.from_euler("xyz", rotation).apply(obj_xyz)
    return obj_xyz


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
        self.save_obs_outs = bool(mp_cfg.get("save_obs_outs", False))
        self.pred_dir = mp_cfg.get("pred_dir")

    def predict(self, task_str=None, variation=None, step_id=0,
                obs_state_dict=None, episode_id=None, instructions=None,
                cache=None):
        taskvar = f"{task_str}+{variation}"
        obs = obs_state_dict
        gripper_pose = copy.deepcopy(np.asarray(obs["gripper"]))

        if step_id == 0:
            cache = _new_episode_cache(gripper_pose, _episode_outdir(
                self.pred_dir, self.save_obs_outs, taskvar, episode_id))
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
        if cache.get("episode_outdir"):
            np.save(os.path.join(cache["episode_outdir"], f"{step_id}.npy"),
                    {"obs": obs, "valid_actions": valid_actions})
        return {"action": np.asarray(valid_actions[0][:8]), "cache": cache}


class RobotPipeline:
    """The released 3D-LOTUS++: a task planner, VLM grounding and the
    motion planner on `device`. Injected parts take the place of those
    the config names: `vlm_pipeline` (anything with run(rgb, pc,
    arm_links_info) -> {objects} and ground_object_with_query), else a
    VLMPipeline over `det` / `sam`; `llm_planner`, else the ground-truth
    planner or an LLMTaskPlanner over `llm_backend` and the config's plan
    cache_file. The episode state (`cache`) is a plain picklable dict the
    caller hands back on the next step."""

    def __init__(self, config, motion_planner: MotionPlannerEngine = None,
                 vlm_pipeline=None, llm_planner=None,
                 text_embedder: ActionTextEmbedder = None, det=None,
                 sam=None, llm_backend=None, device="cuda"):
        self.config = config
        self.env_name = ("real" if config.get("pipeline", {}).get(
            "real_robot", False) else "rlbench")

        llm_cfg = config["llm_planner"]
        if llm_planner is not None:
            self.llm_planner = llm_planner
        elif llm_cfg.get("use_groundtruth", False):
            self.llm_planner = GroundtruthTaskPlanner(
                resolve_asset(llm_cfg["gt_plan_file"]))
        else:
            from ..vlm.llm_planner import LLMTaskPlanner
            self.llm_planner = LLMTaskPlanner(
                prompt_dir=resolve_asset(llm_cfg.get("prompt_dir")),
                asset_dir=resolve_asset(llm_cfg.get("asset_dir")),
                backend=llm_backend, cache_file=llm_cfg.get("cache_file"))

        if vlm_pipeline is not None:
            self.vlm_pipeline = vlm_pipeline
        else:
            from ..vlm.pipeline import VLMPipeline
            self.vlm_pipeline = VLMPipeline(env_name=self.env_name, det=det,
                                            sam=sam)

        mp_cfg = config["motion_planner"]
        self.motion_planner = motion_planner or MotionPlannerEngine(
            mp_cfg["config_file"], mp_cfg.get("checkpoint"), device=device)
        self.mp_data_cfg = self.motion_planner.data_cfg
        self.text_embedder = text_embedder or ActionTextEmbedder(
            mp_cfg.get("action_embed_file"))
        self.run_action_step = int(mp_cfg.get("run_action_step", 1))
        self.restart = bool(config.get("pipeline", {}).get("restart", False))
        self.save_obs_outs = bool(mp_cfg.get("save_obs_outs", False))
        self.pred_dir = mp_cfg.get("pred_dir")
        self.workspace = get_robot_workspace(
            real_robot=self.env_name == "real", use_vlm=True)
        seed = config.get("pipeline", {}).get("seed", 0)
        # seed 0 is a valid explicit seed (`or None` would silently unseed)
        self.rng = np.random.RandomState(
            None if seed is None else int(seed))

    # ------------------------------------------------------------------ #

    def prepare_motion_planner_input(
            self, objects, plan, arm_links_info, gripper_pose,
            zrange=None, target_var_xyz=None):
        """Grounded objects -> the motion planner's labelled, voxelized,
        normalised input, and the grasped object's cloud."""
        cfg = self.mp_data_cfg
        voxel_size = self.motion_planner.act_cfg.get("voxel_size", 0.01)

        pcd_xyz = [np.asarray(o.pcd_xyz, np.float32) for o in objects]
        pcd_rgb = [np.asarray(o.pcd_rgb) if o.pcd_rgb is not None
                   else np.zeros((len(x), 3)) for o, x in zip(objects, pcd_xyz)]
        pcd_label = [np.zeros(len(x), np.int32) for x in pcd_xyz]
        for k, o in enumerate(objects):
            if o.captions and o.captions[0] == "robot":
                pcd_label[k][:] = 1

        mani_obj = None
        for query_key, label_id in (("object", 2), ("target", 3)):
            if plan.get(query_key) is None:
                continue
            query = plan[query_key]
            best_obj_id, _, _ = self.vlm_pipeline.ground_object_with_query(
                query, objects=objects, return_sims=True)
            if best_obj_id is None:
                continue
            if query_key == "object":
                pcd_label[best_obj_id][:] = 2
                mani_obj = {"pcd_xyz": pcd_xyz[best_obj_id],
                            "name": plan.get("ret_val")}
            else:
                if target_var_xyz is not None:
                    # match the remembered object variable by chamfer distance
                    # over uncaptioned objects
                    cand = [k for k, o in enumerate(objects)
                            if not o.captions]
                    if cand:
                        dists = [chamfer_distance_np(
                            target_var_xyz, pcd_xyz[k]) + chamfer_distance_np(
                            pcd_xyz[k], target_var_xyz) for k in cand]
                        best_obj_id = cand[int(np.argmin(dists))]
                pcd_label[best_obj_id][:] = 3
            if zrange is not None:
                z = pcd_xyz[best_obj_id][:, 2]
                pcd_label[best_obj_id][(z < zrange[0]) | (z > zrange[1])] = 0

        pcd_xyz = np.concatenate(pcd_xyz)
        pcd_rgb = np.concatenate(pcd_rgb)
        pcd_label = np.concatenate(pcd_label)

        pcd_xyz, idxs = voxelize_pcd_np(pcd_xyz, voxel_size)
        pcd_label = pcd_label[idxs]
        pcd_rgb = pcd_rgb[idxs]

        rm_robot = cfg.get("rm_robot", "none")
        if rm_robot != "none":
            box = RobotBox(arm_links_info,
                           keep_gripper=rm_robot == "box_keep_gripper",
                           env_name=self.env_name)
            keep = ~box.point_mask(pcd_xyz)
            pcd_xyz, pcd_label, pcd_rgb = \
                pcd_xyz[keep], pcd_label[keep], pcd_rgb[keep]

        num_points = int(cfg.get("num_points", 4096))
        if len(pcd_xyz) <= 10:
            # everything was cleaned/cropped away: signal the caller to emit
            # the safe zero action (the Actioner's tiny-cloud guard) instead
            # of sampling an empty array into a NaN centroid/forward
            return None, mani_obj
        point_idxs = sample_points(
            len(pcd_xyz), num_points,
            cfg.get("same_npoints_per_example", False), self.rng)
        pcd_xyz = pcd_xyz[point_idxs]
        pcd_label = pcd_label[point_idxs]
        pcd_height = pcd_xyz[:, 2] - self.workspace["TABLE_HEIGHT"]
        pcd_rgb = pcd_rgb[point_idxs]

        pcd_xyz, gripper_pose, pc_centroid, pc_radius = normalize_pcd(
            pcd_xyz, gripper_pose, cfg.get("xyz_shift", "center"),
            cfg.get("xyz_norm", False))

        pcd_ft = pcd_xyz
        if cfg.get("use_height", True):
            pcd_ft = np.concatenate([pcd_ft, pcd_height[:, None]], -1)
        if cfg.get("use_color", False):
            pcd_ft = np.concatenate(
                [pcd_ft, (pcd_rgb / 255.0) * 2 - 1], -1)

        inputs = {
            "pc_fts": pcd_ft.astype(np.float32), "pc_labels": pcd_label,
            "pc_centroids": pc_centroid, "pc_radius": pc_radius,
            "ee_poses": gripper_pose,
        }
        return inputs, mani_obj

    def _estimate_zrange(self, plan, task_str, objects):
        """The height range of a drawer's or a safe's level, from the
        planner's estimator, in world z."""
        query = None
        if plan.get("object") is not None and "drawer" in plan["object"]:
            query = plan["object"]
        elif plan.get("target") is not None and "safe" in task_str and (
                "safe" in plan["target"] or "shelf" in plan["target"]):
            query = plan["target"]
        if query is None:
            return None
        heights = np.concatenate([
            o.pcd_xyz[:, 2] for o in objects
            if not o.captions or o.captions[0] != "robot"], 0)
        obj_height = np.percentile(heights, 99) - heights.min()
        if hasattr(self.llm_planner, "estimate_height_range"):
            zrange = self.llm_planner.estimate_height_range(query, obj_height)
        else:
            zrange = heuristic_height_range(query, obj_height)
        if zrange is not None:
            zrange = np.asarray(zrange) + self.workspace["TABLE_HEIGHT"]
        return zrange

    # ------------------------------------------------------------------ #

    def predict(self, task_str=None, variation=None, step_id=0,
                obs_state_dict=None, episode_id=None, instructions=None,
                cache=None):
        taskvar = f"{task_str}+{variation}"
        obs = obs_state_dict
        gripper_pose = copy.deepcopy(np.asarray(obs["gripper"]))

        if step_id == 0:
            outdir = _episode_outdir(self.pred_dir, self.save_obs_outs,
                                     taskvar, episode_id)
            cache = _new_episode_cache(gripper_pose, outdir)
            if isinstance(self.llm_planner, GroundtruthTaskPlanner):
                plans = self.llm_planner(taskvar)
            else:
                _, plans = self.llm_planner(instructions[0])
            cache["highlevel_plans"] = [parse_code(x) for x in plans]
            if outdir:
                with open(os.path.join(outdir, "highlevel_plans.json"),
                          "w") as f:
                    json.dump({
                        # GT-planner callers may omit instructions entirely
                        "instruction": instructions[0] if instructions
                        else None,
                        "plans": plans,
                        "parsed_plans": cache["highlevel_plans"]}, f)

        # cached trajectory steps remaining
        if cache["valid_actions"]:
            cur = np.asarray(cache["valid_actions"][0][:8])
            cache["valid_actions"] = cache["valid_actions"][1:]
            # as upstream, the generating plan is taken as plans[step_id -
            # 1]: the previous plan whenever the stop bit did not fire
            plan = cache["highlevel_plans"][cache["highlevel_step_id"] - 1] \
                if cache["highlevel_step_id"] > 0 else None
            if plan is not None and cache["grasped_obj_name"] is not None \
                    and cache["grasped_obj_name"] in cache["ret_objs"] \
                    and plan["action"].startswith("move grasped object"):
                _move_grasped_obj_xyz(
                    cur, cache["prev_ee_pose"],
                    cache["ret_objs"][cache["grasped_obj_name"]])
            cache["prev_ee_pose"] = cur
            return {"action": cur, "cache": cache}

        if cache["highlevel_step_id"] >= len(cache["highlevel_plans"]):
            if self.restart:
                # rewind to plan 0 and clear the episode state, keeping the
                # plans (the planner runs at step 0 only)
                plans = cache["highlevel_plans"]
                cache.update(_new_episode_cache(
                    gripper_pose, cache["episode_outdir"]))
                cache["highlevel_plans"] = plans
            else:
                return {"action": np.zeros(8), "cache": cache}

        plan = cache["highlevel_plans"][cache["highlevel_step_id"]]
        if plan is None:
            return {"action": np.zeros(8), "cache": cache}

        if plan["action"] == "release":
            action = gripper_pose.copy()
            action[7] = 1
            cache["highlevel_step_id"] += 1
            cache["grasped_obj_name"] = None
            return {"action": action, "cache": cache}

        vlm_results = self.vlm_pipeline.run(
            obs["rgb"], obs["pc"], obs["arm_links_info"])
        objects = vlm_results["objects"] if isinstance(vlm_results, dict) \
            else vlm_results.objects

        target_var_xyz = None
        if plan.get("is_target_variable") and \
                plan["target"] in cache["ret_objs"]:
            target_var_xyz = cache["ret_objs"][plan["target"]]

        zrange = self._estimate_zrange(plan, task_str, objects)

        inputs, mani_obj = self.prepare_motion_planner_input(
            objects, plan, obs["arm_links_info"], gripper_pose,
            zrange=zrange, target_var_xyz=target_var_xyz)
        if inputs is None:  # cleanup/crop emptied the cloud
            return {"action": np.zeros(8), "cache": cache}

        if mani_obj is not None and mani_obj["name"]:
            cache["ret_objs"][mani_obj["name"]] = mani_obj["pcd_xyz"]
            if plan["action"] == "grasp":
                cache["grasped_obj_name"] = mani_obj["name"]

        action_name = _plan_action_name(
            plan, self.mp_data_cfg.get("instr_include_objects", False))
        txt_embed = self.text_embedder(action_name)

        pred_actions = self.motion_planner.predict(
            inputs["pc_fts"], inputs["pc_labels"], txt_embed,
            inputs["ee_poses"], inputs["pc_centroids"], inputs["pc_radius"],
            self.workspace["TABLE_HEIGHT"])

        valid_actions = []
        for t, a in enumerate(pred_actions):
            valid_actions.append(a)
            if t + 1 >= self.run_action_step or a[-1] > 0.5:
                break
        if valid_actions[-1][-1] > 0.5:
            cache["highlevel_step_id"] += 1
        cache["valid_actions"] = [np.asarray(a) for a in valid_actions[1:]]
        out_action = np.asarray(valid_actions[0][:8])

        if cache["episode_outdir"]:
            np.save(os.path.join(cache["episode_outdir"], f"{step_id}.npy"),
                    {"obs": obs, "valid_actions": valid_actions})

        if cache["grasped_obj_name"] is not None and \
                cache["grasped_obj_name"] in cache["ret_objs"] and \
                plan["action"].startswith("move grasped object"):
            _move_grasped_obj_xyz(
                out_action, cache["prev_ee_pose"],
                cache["ret_objs"][cache["grasped_obj_name"]])
        cache["prev_ee_pose"] = out_action
        return {"action": out_action, "cache": cache}
