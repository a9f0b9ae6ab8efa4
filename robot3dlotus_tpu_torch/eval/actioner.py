"""Eval-time Actioner: obs dict -> 8-vector action on the card (port of
robot3dlotus_tpu/eval/actioner.py, its host-preprocess and fused paths).

Host path (the default): multi-camera obs -> workspace crop fused with the
1 cm voxel downsample with trace (the C++ of native/) -> robot-box removal
-> <= num_points sampling -> centre -> presort by the stage-0 SFC code
(host numpy) -> SimplePolicy forward + decode on the device -> un-normalize
and table clamp on the host. Clouds are padded to point-capacity buckets
(num_points/4, /2, /1) and batches to batch buckets, as in the JAX
package; the backbone runs with assume_sorted. The gripper pose
(normalised like the cloud) and the step id go with every cloud, for the
models that read them (use_ee_pose / use_step_id). num_ensembles > 1 runs
that many forwards of the cloud at num_points with the serialization
orders shuffled (each from a Randomness of its own) and averages them:
position and open logit by their mean, the rotation by the mean of its
euler angles (scipy), as the JAX Actioner does.

Fused path (device_preprocess=True, or ROBOT3DLOTUS_DEVICE_PREPROCESS=1):
the raw cloud goes to the device and ops/eval_preprocess.py
make_obs_to_action runs the whole chain there at num_points, with a
fixed-capacity voxelizer (vox_capacity, or ROBOT3DLOTUS_VOX_CAPACITY,
default 8192; a non-zero overflow is logged); one packed vector comes
back. predict_batch then runs fused predicts one after another. Ensembles
take the host path.

Weights come from `checkpoint` (a .msgpack of either package, or an
upstream-layout torch .pt converted by train.torch_convert), loaded with
load_state_dict(strict=True); without one they are a seeded init.

Sharded serving (mesh="dp=2,tp=2", or ROBOT3DLOTUS_SERVE_MESH; JAX's
Actioner(mesh=...)): the processes of a launched group (parallel/dist.py:
torchrun, SLURM) serve together over a dp x tp mesh (parallel/mesh.py).
The model's MLP and CPE pairs run on their tp shards (the JAX TP rules);
predict runs its one row on every dp process; predict_batch gives each
dp process its share of the rows when dp divides the batch bucket, else
every process all of them, and returns every row, in order, on every
process. The contract is SPMD: every process of the group calls with the
same requests, in the same order (each call's collectives pair up across
them). The fused preprocess is turned off under a mesh, with a warning,
as in JAX.

Instruction embeddings come from a precomputed `instr_embed_file`, or, when
the config names none, from the deterministic per-taskvar pseudo-embedding
the synthetic training store uses. On-demand CLIP encoding is not ported.
"""
from __future__ import annotations

import copy
import json
import logging
import os
import time
import zlib

import numpy as np
import torch

from ..configs import get_config
from ..configs.rlbench.constants import get_robot_workspace
from ..models.factory import build_model, resolve_device
from ..models.layers import Randomness
from ..models.simple_policy import decode_actions
from ..native import crop_voxelize_trace_native
from ..ops.eval_preprocess import (make_obs_to_action, obb_params_disabled,
                                   obb_params_np, obb_vector)
from ..ops.sfc_np import sfc_encode_np
from ..train.checkpoint import load_any_model_ckpt
from ..utils.assets import resolve_asset
from ..utils.robot_box import RobotBox

TXT_BUCKETS = (4, 8, 16, 32, 80)
LOGGER = logging.getLogger("robot3dlotus_tpu_torch.eval")


def serving_mesh(model, mesh):
    """The serving mesh of `mesh` (a spec, a Mesh, or None for
    ROBOT3DLOTUS_SERVE_MESH), the model cut to its tp shards; None
    without one."""
    mesh = mesh if mesh is not None else \
        os.environ.get("ROBOT3DLOTUS_SERVE_MESH") or None
    if not mesh:
        return None
    from ..parallel.mesh import mesh_from_spec, shard_model
    mesh = mesh_from_spec(mesh)
    shard_model(model, mesh)
    return mesh


def _bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class Actioner:
    _BATCH_BUCKETS = (1, 2, 4, 8, 16)
    _RAW_BUCKETS = (65536, 131072, 262144, 524288, 1048576)

    def __init__(self, exp_config, checkpoint=None, cli_opts=None,
                 best_disc_pos="max", num_ensembles=1, real_robot=False,
                 save_obs_outs_dir=None, device="cuda", seed=0,
                 device_preprocess=None, vox_capacity=None, mesh=None):
        """checkpoint: a model file (train.checkpoint.load_any_model_ckpt),
        or None for the seeded init of `seed`, which also seeds the
        >num_points subsample (host path: self.rng; fused path: a
        torch.Generator on the device). A file that does not fit the model
        raises. best_disc_pos: 'max' or 'ens1' (the decode's 5 mm vote);
        num_ensembles: the shuffled forwards averaged per request, their
        orders drawn from `seed`. save_obs_outs_dir: each answered
        request's {"obs", "action"} saved there as
        {taskvar}-{episode_id}-{step_id}.npy. device_preprocess /
        vox_capacity: the fused path and its voxel capacity (None:
        ROBOT3DLOTUS_DEVICE_PREPROCESS, default off, and
        ROBOT3DLOTUS_VOX_CAPACITY, default 8192). mesh: a serving mesh
        spec or parallel.mesh.Mesh (None: ROBOT3DLOTUS_SERVE_MESH, unset
        for none); see the module docstring."""
        self.device = resolve_device(device)
        self.num_ensembles = int(num_ensembles)
        self.ensemble_rng = np.random.default_rng([seed, 1])
        self.config = get_config(exp_config, cli_opts)
        self.data_cfg = dict(self.config.TRAIN_DATASET)
        self.act_cfg = dict(self.config.MODEL.action_config)
        self.act_cfg["best_disc_pos"] = best_disc_pos
        self.save_obs_outs_dir = save_obs_outs_dir
        if save_obs_outs_dir:
            os.makedirs(save_obs_outs_dir, exist_ok=True)
        self.real_robot = real_robot
        self.WORKSPACE = get_robot_workspace(real_robot=real_robot)
        self.TABLE_HEIGHT = self.WORKSPACE["TABLE_HEIGHT"]
        self.num_points = int(self.data_cfg.get("num_points", 4096))
        self.rng = np.random.default_rng(seed)
        if device_preprocess is None:
            device_preprocess = bool(int(os.environ.get(
                "ROBOT3DLOTUS_DEVICE_PREPROCESS", "0")))
        self.device_preprocess = bool(device_preprocess) and \
            self.num_ensembles == 1
        self.vox_capacity = int(vox_capacity if vox_capacity is not None
                                else os.environ.get(
                                    "ROBOT3DLOTUS_VOX_CAPACITY", "8192"))
        self.draws = torch.Generator(device=self.device)
        self.draws.manual_seed(seed)
        self._obs_to_action = None
        self._txt_dev = {}
        # host-prep parts of the last process_point_clouds call, ms
        self.prep_ms = {}

        # host-presorted inputs: the backbone skips its entry sort
        model_cfg = {k: (dict(v, assume_sorted=True)
                         if k == "ptv3_config" else v)
                     for k, v in dict(self.config.MODEL).items()}
        self.model = build_model(model_cfg, device=self.device, seed=seed)
        if checkpoint:
            self.model.load_state_dict(load_any_model_ckpt(
                checkpoint, self.model, self.config.MODEL), strict=True)
        self.mesh = serving_mesh(self.model, mesh)
        if self.mesh is not None and self.device_preprocess:
            LOGGER.warning("serve mesh set: the fused device preprocess is "
                           "turned off (the mesh path takes the host "
                           "preprocess)")
            self.device_preprocess = False
        p3 = self.config.MODEL.ptv3_config
        self._presort_cfg = (
            tuple(p3.get("order") or p3.get("orders")
                  or ("z", "z-trans", "hilbert", "hilbert-trans"))[0],
            int(p3.get("serial_depth", 10)),
            float(self.act_cfg.get("voxel_size", 0.01)),
        )
        self._point_buckets = tuple(sorted({
            max(self.num_points // 4, 256), self.num_points // 2,
            self.num_points}))

        self.instr_embeds = {}
        f = resolve_asset(self.data_cfg.get("instr_embed_file"))
        if f and os.path.exists(f):
            self.instr_embeds = np.load(f, allow_pickle=True).item()
            if self.data_cfg.get("instr_embed_type", "all") == "last":
                self.instr_embeds = {k: v[-1:] for k, v in
                                     self.instr_embeds.items()}
        tf = resolve_asset(self.data_cfg.get("taskvar_instr_file"))
        self.taskvar_instrs = {}
        if tf and os.path.exists(tf):
            with open(tf) as fh:
                self.taskvar_instrs = json.load(fh)

    # ------------------------------------------------------------------ #

    def _encode_instruction(self, instr, taskvar=None):
        if instr in self.instr_embeds:
            return self.instr_embeds[instr]
        if not self.data_cfg.get("instr_embed_file") and taskvar:
            # the synthetic store's deterministic per-taskvar embedding
            h = zlib.crc32(taskvar.encode("utf-8")) % (2 ** 31)
            dim = int(self.act_cfg.get("txt_ft_size", 512))
            return np.random.RandomState(h).randn(4, dim).astype(np.float32)
        raise NotImplementedError(
            f"no embedding for instruction {instr!r}: on-demand CLIP "
            "encoding is not ported; give an instr_embed_file that holds it")

    def process_point_clouds(self, xyz, rgb, ee_pose=None,
                             arm_links_info=None):
        """Host preprocessing -> (pc_ft (n, 7) presorted, centroid, radius,
        ee_pose); all None when the crop empties the cloud. Its parts' ms
        land in self.prep_ms."""
        t0 = time.perf_counter()
        xyz = np.ascontiguousarray(xyz.reshape(-1, 3), np.float32)
        xyz, first, _ = crop_voxelize_trace_native(
            xyz, self.act_cfg.get("voxel_size", 0.01), self.WORKSPACE,
            rm_table=self.data_cfg.get("rm_table", True))
        if len(xyz) == 0:
            return None, None, None, None
        rgb = rgb.reshape(-1, 3)[first].astype(np.float32)
        t1 = time.perf_counter()

        if self.data_cfg.get("rm_robot", "none").startswith("box"):
            box = RobotBox(
                arm_links_info,
                keep_gripper=self.data_cfg["rm_robot"] == "box_keep_gripper",
                env_name="real" if self.real_robot else "rlbench")
            keep = ~box.point_mask(xyz)
            xyz, rgb = xyz[keep], rgb[keep]
        t2 = time.perf_counter()

        if len(xyz) > self.num_points:
            idxs = self.rng.choice(len(xyz), self.num_points, replace=False)
            xyz, rgb = xyz[idxs], rgb[idxs]
        height = xyz[:, 2] - self.TABLE_HEIGHT

        shift = self.data_cfg.get("xyz_shift", "center")
        if shift == "none":
            centroid = np.zeros(3, np.float32)
        elif shift == "center":
            centroid = xyz.mean(0)
        else:
            centroid = copy.deepcopy(ee_pose[:3])
        radius = float(np.max(np.linalg.norm(xyz - centroid, axis=1))) \
            if self.data_cfg.get("xyz_norm", False) else 1.0

        xyz = (xyz - centroid) / radius
        height = height / radius
        ee_pose = np.asarray(ee_pose, np.float32).copy()
        ee_pose[:3] = (ee_pose[:3] - centroid) / radius
        rgb = (rgb / 255.0) * 2 - 1
        pc_ft = np.concatenate([xyz, rgb], 1)
        if self.data_cfg.get("use_height", True):
            pc_ft = np.concatenate([pc_ft, height[:, None]], 1)
        t3 = time.perf_counter()
        pc_ft = self._presort(pc_ft.astype(np.float32))
        t4 = time.perf_counter()
        self.prep_ms = {"crop_voxelize": (t1 - t0) * 1e3,
                        "robot_box": (t2 - t1) * 1e3,
                        "subsample": (t3 - t2) * 1e3,
                        "presort": (t4 - t3) * 1e3}
        return pc_ft, centroid, radius, ee_pose

    def _presort(self, pc_ft):
        """Sort the cloud by the backbone's stage-0 SFC code: the same
        float32 grid math as ptv3.compute_grid_coord."""
        order0, depth, grid_size = self._presort_cfg
        xyz = pc_ft[:, :3]
        gc = np.floor((xyz - xyz.min(0, keepdims=True)) /
                      np.float32(grid_size)).astype(np.int32)
        np.clip(gc, 0, (1 << depth) - 1, out=gc)
        code = sfc_encode_np(gc, order0, depth)
        return pc_ft[np.argsort(code, kind="stable")]

    def _instruction(self, task_str, variation, instructions):
        taskvar = f"{task_str}+{variation}"
        if instructions is None:
            instructions = self.taskvar_instrs.get(taskvar, ["do the task"])
        return self._encode_instruction(instructions[0], taskvar=taskvar)

    def _host_prep(self, task_str, variation, obs, instructions):
        instr_embed = self._instruction(task_str, variation, instructions)
        pc_ft, centroid, radius, ee_pose = self.process_point_clouds(
            np.stack(obs["pc"], 0), np.stack(obs["rgb"], 0),
            ee_pose=copy.deepcopy(np.asarray(obs["gripper"])),
            arm_links_info=obs.get("arm_links_info"))
        return instr_embed, pc_ft, centroid, radius, ee_pose

    def _zero_action(self):
        action = np.zeros(8, np.float32)
        action[2] = self.TABLE_HEIGHT + 0.005
        return action

    def _finish_action(self, action, centroid, radius):
        """Threshold the open logit, un-normalize, clamp z above the table."""
        action[-1] = float(1.0 / (1.0 + np.exp(-action[-1])) > 0.5)
        action[:3] = action[:3] * radius + centroid
        action[2] = max(action[2], self.TABLE_HEIGHT + 0.005)
        return action

    def _batch(self, rows, B, N=None, T=None):
        """(B, ...) device batch from [(pc_ft, instr_embed, ee_pose,
        step_id)] rows at the rows' point bucket (or N) and text bucket
        (or T); padding rows repeat row 0."""
        N = N or _bucket(max(len(r[0]) for r in rows), self._point_buckets)
        T = T or _bucket(max(r[1].shape[0] for r in rows), TXT_BUCKETS)
        cin = rows[0][0].shape[-1]
        pc = np.zeros((B, N, cin), np.float32)
        mask = np.zeros((B, N), bool)
        counts = np.zeros(B, np.int64)
        txt = np.zeros((B, T, rows[0][1].shape[-1]), np.float32)
        tmask = np.zeros((B, T), bool)
        ee = np.zeros((B, 8), np.float32)
        steps = np.zeros(B, np.int64)
        for r in range(B):
            pc_ft, instr_embed, ee[r], steps[r] = rows[r] if r < len(rows) \
                else rows[0]
            n = min(len(pc_ft), N)
            pc[r, :n], mask[r, :n], counts[r] = pc_ft[:n], True, n
            t = min(instr_embed.shape[0], T)
            txt[r, :t], tmask[r, :t] = instr_embed[:t], True
        to = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        return {"pc_fts": to(pc), "pc_mask": to(mask), "pc_counts": to(counts),
                "txt_embeds": to(txt), "txt_mask": to(tmask),
                "ee_poses": to(ee), "step_ids": to(steps)}

    @torch.inference_mode()
    def _forward(self, rows, B):
        if self.mesh is not None:
            return self._mesh_forward(rows, B)
        preds = self.model(self._batch(rows, B))
        return decode_actions(preds, self.act_cfg).cpu().numpy()

    def _mesh_forward(self, rows, B):
        """_forward over the serving mesh: this dp process's rows of the
        B-row batch (parallel.mesh.eval_rows) at the whole batch's
        buckets, then every row gathered in order."""
        from ..parallel.mesh import eval_rows, gather_rows
        N = _bucket(max(len(r[0]) for r in rows), self._point_buckets)
        T = _bucket(max(r[1].shape[0] for r in rows), TXT_BUCKETS)
        full = [rows[r] if r < len(rows) else rows[0] for r in range(B)]
        mine = full[eval_rows(B, self.mesh)]
        preds = self.model(self._batch(mine, len(mine), N=N, T=T))
        actions = decode_actions(preds, self.act_cfg)
        return gather_rows(actions, B, self.mesh).cpu().numpy()

    def _ensemble_rngs(self):
        """One Randomness per ensemble member: its order shuffles."""
        base = int(self.ensemble_rng.integers(0, 2 ** 31 - self.num_ensembles))
        return [Randomness(base + i, self.device)
                for i in range(self.num_ensembles)]

    @torch.inference_mode()
    def _ensemble_forward(self, row):
        """num_ensembles shuffled forwards of one row at num_points: the
        mean position and open logit, the rotation averaged in euler
        space."""
        from scipy.spatial.transform import Rotation as R
        batch = self._batch([row], 1, N=self.num_points)
        actions = np.stack([
            decode_actions(self.model(batch, rng), self.act_cfg)[0]
            .cpu().numpy() for rng in self._ensemble_rngs()])
        avg = actions.mean(0)
        eulers = np.stack([R.from_quat(a[3:7]).as_euler("xyz")
                           for a in actions], 0)
        quat = R.from_euler("xyz", eulers.mean(0)).as_quat()
        return np.concatenate([avg[:3], quat, avg[-1:]], 0)

    # -------------------------------------------- the fused path --

    def _fused_fn(self):
        if self._obs_to_action is None:
            self._obs_to_action = make_obs_to_action(
                self.model, self.act_cfg, self.data_cfg, self.WORKSPACE,
                self.num_points, vox_capacity=self.vox_capacity)
        return self._obs_to_action

    def _staged_txt(self, instr_embed):
        """(txt (T, D), mask (T,)) on the device, T at its text bucket;
        kept per embedding content."""
        key = instr_embed.tobytes()
        if key not in self._txt_dev:
            T = _bucket(instr_embed.shape[0], TXT_BUCKETS)
            txt = np.zeros((T, instr_embed.shape[-1]), np.float32)
            t = min(instr_embed.shape[0], T)
            txt[:t] = instr_embed[:t]
            tmask = np.arange(T) < t
            self._txt_dev[key] = (torch.from_numpy(txt).to(self.device),
                                  torch.from_numpy(tmask).to(self.device))
        return self._txt_dev[key]

    def _fused_inputs(self, obs, instr_embed, step_id):
        """The fused program's arguments for one observation: the raw
        cloud padded to its raw bucket, the link boxes, the staged text,
        [step_id, ee_pose] and the subsample draws."""
        xyz = np.stack(obs["pc"], 0).reshape(-1, 3).astype(np.float32)
        rgb = np.stack(obs["rgb"], 0).reshape(-1, 3).astype(np.float32)
        cap = _bucket(len(xyz), self._RAW_BUCKETS)
        if len(xyz) > cap:
            LOGGER.warning("raw cloud (%d points) exceeds the largest fused "
                           "bucket (%d): the trailing points are dropped; "
                           "serve this camera setup on the host path",
                           len(xyz), cap)
        n = min(len(xyz), cap)
        raw_xyz = np.zeros((cap, 3), np.float32)
        raw_rgb = np.zeros((cap, 3), np.float32)
        raw_xyz[:n], raw_rgb[:n] = xyz[:n], rgb[:n]
        if str(self.data_cfg.get("rm_robot", "none")).startswith("box"):
            obb = obb_params_np(RobotBox(
                obs.get("arm_links_info"),
                keep_gripper=self.data_cfg["rm_robot"] == "box_keep_gripper",
                env_name="real" if self.real_robot else "rlbench"))
        else:
            obb = obb_params_disabled()
        step_ee = np.concatenate([[np.float32(step_id)], np.asarray(
            obs["gripper"], np.float32)]).astype(np.float32)
        to = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        txt, tmask = self._staged_txt(instr_embed)
        draws = torch.rand(self.vox_capacity, generator=self.draws,
                           device=self.device)
        return (to(raw_xyz), to(raw_rgb), n, to(obb_vector(obb)), txt, tmask,
                to(step_ee), draws)

    def _device_predict(self, obs, instr_embed, step_id):
        """One fused predict: the packed [action | count | vox_overflow]
        read back once; an overflow is logged before the tiny-cloud guard
        (a capacity far too small shows as a tiny cloud)."""
        packed = self._fused_fn()(
            *self._fused_inputs(obs, instr_embed, step_id)).cpu().numpy()
        action, count, vox_overflow = packed[:8].copy(), int(packed[8]), \
            int(packed[9])
        if vox_overflow > 0:
            LOGGER.warning(
                "fused voxelizer dropped %d occupied voxels / points (the "
                "capacity %d exceeded: a contiguous workspace corner, and/or "
                "points past the 2^10-cell grid extent); raise "
                "ROBOT3DLOTUS_VOX_CAPACITY or check voxel_size",
                vox_overflow, self.vox_capacity)
        if count <= 10:
            return self._zero_action()
        action[-1] = float(1.0 / (1.0 + np.exp(-action[-1])) > 0.5)
        return action

    def _save_obs_out(self, task_str, variation, episode_id, step_id, obs,
                      action):
        if self.save_obs_outs_dir:
            np.save(os.path.join(
                self.save_obs_outs_dir,
                f"{task_str}+{variation}-{episode_id}-{step_id}.npy"),
                {"obs": obs, "action": action})

    def predict(self, task_str=None, variation=None, step_id=0,
                obs_state_dict=None, episode_id=None, instructions=None):
        if self.device_preprocess:
            action = self._device_predict(
                obs_state_dict, self._instruction(task_str, variation,
                                                  instructions),
                step_id or 0)
            self._save_obs_out(task_str, variation, episode_id, step_id,
                               obs_state_dict, action)
            return {"action": action}
        instr_embed, pc_ft, centroid, radius, ee_pose = self._host_prep(
            task_str, variation, obs_state_dict, instructions)
        if pc_ft is None or len(pc_ft) <= 10:
            return {"action": self._zero_action()}
        row = (pc_ft, instr_embed, ee_pose, step_id or 0)
        action = self._ensemble_forward(row) if self.num_ensembles > 1 \
            else self._forward([row], 1)[0]
        action = self._finish_action(action, centroid, radius)
        self._save_obs_out(task_str, variation, episode_id, step_id,
                           obs_state_dict, action)
        return {"action": action}

    def predict_batch(self, payloads):
        """Serve several queued `predict` queries in batched forwards:
        batch sizes bucketed, padding rows discarded, batches over the top
        bucket split in chunks. Per-row prep and decode are predict's. The
        fused path and ensembles serve the queries one after another."""
        if self.device_preprocess or self.num_ensembles > 1 or \
                len(payloads) == 1:
            return [self.predict(**p) for p in payloads]
        outs = [None] * len(payloads)
        prepped = []
        for i, p in enumerate(payloads):
            instr_embed, pc_ft, centroid, radius, ee_pose = self._host_prep(
                p.get("task_str"), p.get("variation"), p["obs_state_dict"],
                p.get("instructions"))
            if pc_ft is None or len(pc_ft) <= 10:
                outs[i] = {"action": self._zero_action()}
            else:
                prepped.append((i, (pc_ft, instr_embed, ee_pose,
                                    p.get("step_id") or 0), centroid, radius))
        cap = self._BATCH_BUCKETS[-1]
        for c0 in range(0, len(prepped), cap):
            chunk = prepped[c0:c0 + cap]
            actions = self._forward([row for _, row, _, _ in chunk],
                                    _bucket(len(chunk), self._BATCH_BUCKETS))
            for r, (i, _, centroid, radius) in enumerate(chunk):
                action = self._finish_action(actions[r].copy(), centroid,
                                             radius)
                outs[i] = {"action": action}
                p = payloads[i]
                self._save_obs_out(p.get("task_str"), p.get("variation"),
                                   p.get("episode_id"), p.get("step_id"),
                                   p["obs_state_dict"], action)
        return outs
