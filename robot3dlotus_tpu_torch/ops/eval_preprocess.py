"""Fused on-device serving preprocess (the port's copy of
robot3dlotus_tpu/ops/eval_preprocess.py): the raw multi-camera cloud to an
action on the device, static shapes throughout:

  raw (R, 3) padded cloud
    -> workspace / table mask                     (compares)
    -> voxelize_fixed                             (sort + segment sums)
    -> robot OBB removal                          (one (V, 3K) matmul)
    -> random <= num_points subsample             (argsort of draws)
    -> centre / normalise + feature assembly
    -> presort by the stage-0 SFC code            (argsort)
    -> policy forward -> decode -> un-normalise + table clamp

The host only stacks the camera buffers, the link boxes and the draws,
and reads one packed (10,) vector back. The subsample's (V,) uniform draws
are an argument: the caller draws them from its own torch.Generator (the
JAX program draws them from a key inside). The entry sort the JAX model
makes is done here, before the model, with plain indexing: the serving
model is built assume_sorted, so its kernel launches per forward are those
of the host path.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.ptv3 import compute_grid_coord
from .serialization import SENTINEL, sfc_encode
from .voxel import voxelize_fixed


def obb_params_disabled() -> Dict[str, np.ndarray]:
    """OBB parameters that remove nothing: negative half extents make
    |local| <= half false on every axis (all-zero parameters would remove
    every point)."""
    return {"obb_rot": np.zeros((3, 3), np.float32),
            "obb_off": np.zeros(3, np.float32),
            "obb_half": np.full(3, -1.0, np.float32)}


def obb_params_np(box) -> Dict[str, np.ndarray]:
    """RobotBox -> the stacked OBB test: point p is inside box k iff
    |p @ rot_cat[:, 3k:3k+3] - off[3k:3k+3]| <= half[3k:3k+3] on every
    axis. A box list with no links (whose point_mask is all False) gives
    the remove-nothing parameters."""
    if not box.boxes:
        return obb_params_disabled()
    rot_cat, off, half = box._stack()[:3]
    return {"obb_rot": np.ascontiguousarray(rot_cat, np.float32),  # (3, 3K)
            "obb_off": np.ascontiguousarray(off, np.float32),      # (3K,)
            "obb_half": np.ascontiguousarray(half, np.float32)}    # (3K,)


def obb_vector(obb) -> np.ndarray:
    """The (15K,) vector [rot.ravel() | off | half] make_obs_to_action
    takes."""
    return np.concatenate([
        np.ascontiguousarray(obb["obb_rot"], np.float32).ravel(),
        obb["obb_off"], obb["obb_half"]]).astype(np.float32)


def device_preprocess(
    xyz_raw, rgb_raw, raw_valid, obb_rot, obb_off, obb_half, ee_pose,
    sample_u, *, workspace, num_points, voxel_size=0.01, vox_capacity=8192,
    rm_table=True, rm_robot=True, xyz_shift="center", xyz_norm=False,
    use_height=True,
):
    """One observation -> (pc_ft (N, C), mask (N,), count, centroid,
    radius, ee_pose normalised, vox_overflow), N = num_points.

    xyz_raw / rgb_raw: (R, 3) float32 (rgb in 0..255); raw_valid: (R,)
    bool; obb_*: the stacked robot link boxes (obb_params_np; negative
    half extents or rm_robot=False remove nothing); sample_u: (V,) uniform
    draws in [0, 1), V = vox_capacity: the kept voxels with the smallest
    draws are taken (np.random.choice without replacement), all of them
    when fewer than num_points survive."""
    ws = workspace
    m = ((xyz_raw[:, 0] > ws["X_BBOX"][0]) & (xyz_raw[:, 0] < ws["X_BBOX"][1])
         & (xyz_raw[:, 1] > ws["Y_BBOX"][0])
         & (xyz_raw[:, 1] < ws["Y_BBOX"][1])
         & (xyz_raw[:, 2] > ws["Z_BBOX"][0])
         & (xyz_raw[:, 2] < ws["Z_BBOX"][1]) & raw_valid)
    if rm_table:
        m = m & (xyz_raw[:, 2] > ws["TABLE_HEIGHT"])

    vox_xyz, vmask, first, vox_overflow = voxelize_fixed(
        xyz_raw, m, voxel_size, vox_capacity)
    vox_rgb = rgb_raw[first]

    keep = vmask
    if rm_robot:
        local = vox_xyz @ obb_rot - obb_off                       # (V, 3K)
        inside = (local.abs() <= obb_half).reshape(
            vox_xyz.shape[0], -1, 3).all(-1).any(-1)
        keep = keep & ~inside

    r = torch.where(keep, sample_u, torch.full_like(sample_u, float("inf")))
    order = torch.argsort(r, stable=True)[:num_points]
    xyz, rgb, mask = vox_xyz[order], vox_rgb[order], keep[order]
    count = mask.sum()
    height = xyz[:, 2] - ws["TABLE_HEIGHT"]

    if xyz_shift == "none":
        centroid = xyz.new_zeros(3)
    elif xyz_shift == "center":
        mf = mask[:, None].to(xyz.dtype)
        centroid = (xyz * mf).sum(0) / mf.sum().clamp(min=1.0)
    else:  # gripper
        centroid = ee_pose[:3]
    if xyz_norm:
        d = torch.linalg.vector_norm(xyz - centroid, dim=1)
        radius = torch.where(mask, d, torch.zeros_like(d)).amax().clamp(
            min=1e-6)
    else:
        radius = torch.ones((), dtype=xyz.dtype, device=xyz.device)

    xyz_n = (xyz - centroid) / radius
    height = height / radius
    ee = ee_pose.clone()
    ee[:3] = (ee_pose[:3] - centroid) / radius
    feats = [xyz_n, (rgb / 255.0) * 2.0 - 1.0]
    if use_height:
        feats.append(height[:, None])
    pc_ft = torch.cat(feats, 1)
    pc_ft = torch.where(mask[:, None], pc_ft, torch.zeros_like(pc_ft))
    return pc_ft, mask, count, centroid, radius, ee, vox_overflow


def make_obs_to_action(model, act_cfg, data_cfg, workspace, num_points,
                       vox_capacity=8192):
    """The fused obs -> action callable of a SimplePolicy `model` (its
    device is the inputs'):

      fn(xyz_raw (R, 3), rgb_raw (R, 3), n_raw, obb_vec (15K,), txt_embeds
         (T, D), txt_mask (T,), step_ee (9,) [step_id, ee_pose(8)],
         sample_u (vox_capacity,)) -> (10,) [action (8) | count |
         vox_overflow]

    with the first n_raw rows of the raw buffers valid. The action is
    final (position un-normalised and clamped above the table, xyzw
    quaternion, raw open logit); `count` lets the caller apply the
    tiny-cloud guard, and a non-zero `vox_overflow` means the fixed
    capacity voxelizer dropped a region."""
    from ..models.simple_policy import decode_actions

    if vox_capacity < num_points:
        raise ValueError(
            f"vox_capacity ({vox_capacity}) < num_points ({num_points}): "
            "the subsample would emit fewer rows than the model was "
            "trained with; raise ROBOT3DLOTUS_VOX_CAPACITY")
    voxel_size = float(act_cfg.get("voxel_size", 0.01))
    kw = dict(workspace={k: (tuple(v) if isinstance(v, (list, tuple,
                                                         np.ndarray))
                             else float(v)) for k, v in workspace.items()},
              num_points=num_points, voxel_size=voxel_size,
              vox_capacity=vox_capacity,
              rm_table=bool(data_cfg.get("rm_table", True)),
              rm_robot=str(data_cfg.get("rm_robot", "none")).startswith(
                  "box"),
              xyz_shift=data_cfg.get("xyz_shift", "center"),
              xyz_norm=bool(data_cfg.get("xyz_norm", False)),
              use_height=bool(data_cfg.get("use_height", True)))
    table_h = float(workspace["TABLE_HEIGHT"])
    p3 = model.ptv3_model

    @torch.inference_mode()
    def fn(xyz_raw, rgb_raw, n_raw, obb_vec, txt_embeds, txt_mask, step_ee,
           sample_u):
        raw_valid = torch.arange(xyz_raw.shape[0],
                                 device=xyz_raw.device) < n_raw
        k3 = obb_vec.shape[0] // 15 * 3
        pc_ft, mask, count, centroid, radius, ee, vox_overflow = \
            device_preprocess(
                xyz_raw, rgb_raw, raw_valid, obb_vec[:3 * k3].reshape(3, k3),
                obb_vec[3 * k3:4 * k3], obb_vec[4 * k3:5 * k3], step_ee[1:9],
                sample_u, **kw)
        # the entry sort of the backbone (stable, by the stage-0 code of
        # the valid rows' grid; invalid rows last)
        gc = compute_grid_coord(pc_ft[None, :, :3], mask[None], p3.grid_size,
                                p3.serial_depth)
        code = torch.where(mask[None], sfc_encode(gc, p3.orders[0],
                                                  p3.serial_depth),
                           torch.full_like(gc[..., 0], SENTINEL))
        sort0 = torch.argsort(code, dim=-1, stable=True)[0]
        batch = {"pc_fts": pc_ft[sort0][None], "pc_mask": mask[sort0][None],
                 "pc_counts": count[None], "txt_embeds": txt_embeds[None],
                 "txt_mask": txt_mask[None], "ee_poses": ee[None],
                 "step_ids": step_ee[:1].long()}
        action = decode_actions(model(batch), act_cfg)[0]        # (8,)
        pos = action[:3] * radius + centroid
        pos = torch.cat([pos[:2], pos[2:].clamp(min=table_h + 0.005)])
        return torch.cat([pos, action[3:], count.to(pos.dtype)[None],
                          vox_overflow.to(pos.dtype)[None]])

    return fn
