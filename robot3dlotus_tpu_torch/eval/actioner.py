"""Eval-time Actioner: obs dict -> 8-vector action on the card (port of the
host-preprocess path of robot3dlotus_tpu/eval/actioner.py).

Multi-camera obs -> workspace crop -> 1 cm voxel downsample with trace ->
robot-box removal -> <= num_points sampling -> centre -> presort by the
stage-0 SFC code (host numpy) -> SimplePolicy forward + decode on the
device -> un-normalize and table clamp on the host. Clouds are padded to
point-capacity buckets (num_points/4, /2, /1) and batches to batch buckets,
as in the JAX package; the backbone runs with assume_sorted.

Weights come from `checkpoint` (a .msgpack of either package, or an
upstream-layout torch .pt converted by train.torch_convert), loaded with
load_state_dict(strict=True); without one they are a seeded init.

Instruction embeddings come from a precomputed `instr_embed_file`, or, when
the config names none, from the deterministic per-taskvar pseudo-embedding
the synthetic training store uses. On-demand CLIP encoding is not ported.
"""
from __future__ import annotations

import copy
import json
import os
import zlib

import numpy as np
import torch

from ..configs import get_config
from ..configs.rlbench.constants import get_robot_workspace
from ..models.factory import build_model, resolve_device
from ..models.simple_policy import decode_actions
from ..ops.serialization import sfc_encode_np
from ..ops.voxel import voxelize_pcd_np, workspace_mask_np
from ..train.checkpoint import load_any_model_ckpt
from ..utils.assets import resolve_asset
from ..utils.robot_box import RobotBox

TXT_BUCKETS = (4, 8, 16, 32, 80)


def _bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class Actioner:
    _BATCH_BUCKETS = (1, 2, 4, 8, 16)

    def __init__(self, exp_config, checkpoint=None, cli_opts=None,
                 real_robot=False, device="cuda", seed=0):
        """checkpoint: a model file (train.checkpoint.load_any_model_ckpt),
        or None for the seeded init of `seed`, which also drives the
        >num_points subsample. A file that does not fit the model
        raises."""
        self.device = resolve_device(device)
        self.config = get_config(exp_config, cli_opts)
        self.data_cfg = dict(self.config.TRAIN_DATASET)
        self.act_cfg = dict(self.config.MODEL.action_config)
        self.real_robot = real_robot
        self.WORKSPACE = get_robot_workspace(real_robot=real_robot)
        self.TABLE_HEIGHT = self.WORKSPACE["TABLE_HEIGHT"]
        self.num_points = int(self.data_cfg.get("num_points", 4096))
        self.rng = np.random.default_rng(seed)

        # host-presorted inputs: the backbone skips its entry sort
        model_cfg = {k: (dict(v, assume_sorted=True)
                         if k == "ptv3_config" else v)
                     for k, v in dict(self.config.MODEL).items()}
        self.model = build_model(model_cfg, device=self.device, seed=seed)
        if checkpoint:
            self.model.load_state_dict(load_any_model_ckpt(
                checkpoint, self.model, self.config.MODEL), strict=True)
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
        ee_pose); all None when the crop empties the cloud."""
        xyz = np.ascontiguousarray(xyz.reshape(-1, 3), np.float32)
        rgb = rgb.reshape(-1, 3).astype(np.float32)
        voxel_size = self.act_cfg.get("voxel_size", 0.01)
        in_mask = workspace_mask_np(xyz, self.WORKSPACE,
                                    rm_table=self.data_cfg.get("rm_table",
                                                               True))
        xyz, rgb = xyz[in_mask], rgb[in_mask]
        if len(xyz) == 0:
            return None, None, None, None
        xyz, first = voxelize_pcd_np(xyz, voxel_size)
        rgb = rgb[first]

        if self.data_cfg.get("rm_robot", "none").startswith("box"):
            box = RobotBox(
                arm_links_info,
                keep_gripper=self.data_cfg["rm_robot"] == "box_keep_gripper",
                env_name="real" if self.real_robot else "rlbench")
            keep = ~box.point_mask(xyz)
            xyz, rgb = xyz[keep], rgb[keep]

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
        return self._presort(pc_ft.astype(np.float32)), centroid, radius, \
            ee_pose

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

    def _host_prep(self, task_str, variation, obs, instructions):
        taskvar = f"{task_str}+{variation}"
        if instructions is None:
            instructions = self.taskvar_instrs.get(taskvar, ["do the task"])
        instr_embed = self._encode_instruction(instructions[0],
                                               taskvar=taskvar)
        pc_ft, centroid, radius, _ = self.process_point_clouds(
            np.stack(obs["pc"], 0), np.stack(obs["rgb"], 0),
            ee_pose=copy.deepcopy(np.asarray(obs["gripper"])),
            arm_links_info=obs.get("arm_links_info"))
        return instr_embed, pc_ft, centroid, radius

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

    def _batch(self, rows, B):
        """(B, ...) device batch from [(pc_ft, instr_embed)] rows at the
        rows' point and text buckets; padding rows repeat row 0."""
        N = _bucket(max(len(r[0]) for r in rows), self._point_buckets)
        T = _bucket(max(r[1].shape[0] for r in rows), TXT_BUCKETS)
        cin = rows[0][0].shape[-1]
        pc = np.zeros((B, N, cin), np.float32)
        mask = np.zeros((B, N), bool)
        counts = np.zeros(B, np.int64)
        txt = np.zeros((B, T, rows[0][1].shape[-1]), np.float32)
        tmask = np.zeros((B, T), bool)
        for r in range(B):
            pc_ft, instr_embed = rows[r] if r < len(rows) else rows[0]
            n = min(len(pc_ft), N)
            pc[r, :n], mask[r, :n], counts[r] = pc_ft[:n], True, n
            t = min(instr_embed.shape[0], T)
            txt[r, :t], tmask[r, :t] = instr_embed[:t], True
        to = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        return {"pc_fts": to(pc), "pc_mask": to(mask), "pc_counts": to(counts),
                "txt_embeds": to(txt), "txt_mask": to(tmask)}

    @torch.inference_mode()
    def _forward(self, rows, B):
        preds = self.model(self._batch(rows, B))
        return decode_actions(preds, self.act_cfg).cpu().numpy()

    def predict(self, task_str=None, variation=None, step_id=0,
                obs_state_dict=None, episode_id=None, instructions=None):
        instr_embed, pc_ft, centroid, radius = self._host_prep(
            task_str, variation, obs_state_dict, instructions)
        if pc_ft is None or len(pc_ft) <= 10:
            return {"action": self._zero_action()}
        action = self._forward([(pc_ft, instr_embed)], 1)[0]
        return {"action": self._finish_action(action, centroid, radius)}

    def predict_batch(self, payloads):
        """Serve several queued `predict` queries in batched forwards:
        batch sizes bucketed, padding rows discarded, batches over the top
        bucket split in chunks. Per-row prep and decode are predict's."""
        if len(payloads) == 1:
            return [self.predict(**payloads[0])]
        outs = [None] * len(payloads)
        prepped = []
        for i, p in enumerate(payloads):
            instr_embed, pc_ft, centroid, radius = self._host_prep(
                p.get("task_str"), p.get("variation"), p["obs_state_dict"],
                p.get("instructions"))
            if pc_ft is None or len(pc_ft) <= 10:
                outs[i] = {"action": self._zero_action()}
            else:
                prepped.append((i, pc_ft, instr_embed, centroid, radius))
        cap = self._BATCH_BUCKETS[-1]
        for c0 in range(0, len(prepped), cap):
            chunk = prepped[c0:c0 + cap]
            actions = self._forward([(pc, emb) for _, pc, emb, _, _ in chunk],
                                    _bucket(len(chunk), self._BATCH_BUCKETS))
            for r, (i, _, _, centroid, radius) in enumerate(chunk):
                outs[i] = {"action": self._finish_action(
                    actions[r].copy(), centroid, radius)}
        return outs
