"""3D-LOTUS++ motion planner (port of robot3dlotus_tpu/models/
motion_planner.py `MotionPlannerTPU`, `TrajActionHead`, `compute_mp_loss`
and `decode_mp_actions`), in its CA variant (the action-text tokens, and a
pose token under use_ee_pose, through cross-attention blocks) and its
AdaNorm variant (the policy's context vector modulating the norms, JAX's
default).

Against the keystep policy:
  * every point carries a semantic label (0 obstacle, 1 robot, 2 object,
    3 target), embedded by `pc_label_embedding` and fed to the stem conv
    only, as a categorical channel (ops/sparse_conv.py categorical_conv);
  * the head predicts a trajectory of max_traj_len poses and a stop logit
    per step, each step conditioned by a learned trajectory-step embedding;
  * the losses are masked per valid trajectory step.

Batch layout: the policy's (simple_policy.py) plus
  pc_labels      (B, N) int in [0, 4)
and for the loss:
  gt_trajs       (B, L, 3 + R + 1)  pos (3) + the rot_pred_type's target
                 + open
  gt_trajs_stop  (B, L)
  traj_masks     (B, L) bool
The position targets are built on the device in the backbone's sorted
frame (build_disc_pos_targets); batches never carry disc_pos_probs.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pos_codec import best_pos_from_disc_logits
from ..parallel import dist
from . import heads
from .heads import rotation_output
from .layers import dense, dropout, trunc_normal_
from .simple_policy import (Conditioned, backbone, build_disc_pos_targets,
                            embedding, rotation_to_quat)


class _SplitDense(nn.Linear):
    """A Linear over concat([a, b], -1) applied factored: a @ W[:, :split]^T
    and b @ W[:, split:]^T separately, so the caller broadcast-adds the
    two products instead of building the concatenated input. One weight,
    like the flax `_SplitDense` kernel it carries."""

    def __init__(self, split, extra, features, generator):
        super().__init__(split + extra, features)
        self.split = split
        with torch.no_grad():
            trunc_normal_(self.weight, generator)
            self.bias.zero_()

    def forward(self, a, b):
        ya = a @ self.weight[:, :self.split].T
        yb = None if b is None else b @ self.weight[:, self.split:].T
        return ya, yb


class TrajActionHead(nn.Module):
    """Per trajectory step: the position (heatmap_disc logits per point, or
    any other pos_pred_type: heatmap_mlp, a softmax over the points of
    offset coordinates), the rotation of rot_pred_type (euler_disc bins;
    quat, rot6d, else 3 angles), openness and stop logits from a masked
    max or mean over the points (reduce 'attn' raises, as in the JAX head).
    fc1 of each MLP is factored over (points, steps): the per-point
    product is computed once and the per-step product added."""

    def __init__(self, generator, dim, reduce="max",
                 pos_pred_type="heatmap_disc", rot_pred_type="euler_disc",
                 hidden_size=128, dim_actions=7, max_traj_len=5,
                 traj_embed_size=64, dropout=0.0, euler_resolution=5,
                 pos_bins=50):
        super().__init__()
        if reduce not in ("max", "mean"):
            raise NotImplementedError(reduce)
        g = generator
        self.reduce, self.pos_pred_type = reduce, pos_pred_type
        self.rot_pred_type = rot_pred_type
        self.max_traj_len, self.pos_bins = max_traj_len, pos_bins
        self.dropout = dropout
        self.euler_bins = 360 // euler_resolution
        E = traj_embed_size
        if E > 0:
            self.traj_embedding = embedding(max_traj_len, E, g)
        out = self.euler_bins * 3 if rot_pred_type == "euler_disc" \
            else dim_actions - 3
        self.heatmap_mlp_fc1 = _SplitDense(dim, E, hidden_size, g)
        self.heatmap_mlp_fc2 = dense(
            hidden_size, 3 * pos_bins * 2
            if pos_pred_type == "heatmap_disc" else 4, g)
        self.action_mlp_fc1 = _SplitDense(dim, E, hidden_size, g)
        self.action_mlp_fc2 = dense(hidden_size, out + 2, g)

    def _fc1(self, fc1, x, te, shape):
        """fc1(concat(x, te)) broadcast to `shape` (..., L, hidden)."""
        ya, yb = fc1(x, te)
        h = ya[..., None, :] + fc1.bias
        h = h.expand(shape) if yb is None else h + yb
        return F.leaky_relu(h, negative_slope=0.02)

    def forward(self, point_embeds, mask, coords=None, temp=1.0, rng=None):
        """point_embeds (B, N, D); mask (B, N); coords (B, N, 3), read by
        heatmap_mlp. Returns xt (B, L, 3, N, 2*pos_bins) logits, or (B, L,
        3) under heatmap_mlp; xr (B, L, euler_bins, 3) logits, or (B, L,
        dim); xo (B, L) openness and xstop (B, L) stop logits."""
        B, N, _ = point_embeds.shape
        L, nb = self.max_traj_len, 2 * self.pos_bins
        hidden = self.heatmap_mlp_fc2.in_features
        te = self.traj_embedding.weight if hasattr(
            self, "traj_embedding") else None
        h = self._fc1(self.heatmap_mlp_fc1, point_embeds, te,
                      (B, N, L, hidden))
        ht = self.heatmap_mlp_fc2(dropout(h, self.dropout, self.training,
                                          rng))
        if self.pos_pred_type == "heatmap_disc":
            # 'n t (c b) -> t c n b' per cloud, padded points out of the
            # softmax
            xt = ht.reshape(B, N, L, 3, nb).permute(0, 2, 3, 1, 4)
            xt = torch.where(mask[:, None, None, :, None], xt,
                             torch.full_like(xt, -1e9))
        else:                                                # (B, N, L, 4)
            heat = ht[..., 0] / temp
            w = torch.softmax(torch.where(mask[:, :, None], heat,
                                          torch.full_like(heat, -1e9)), dim=1)
            xt = torch.einsum("bnt,bntc->btc", w,
                              coords[:, :, None, :] + ht[..., 1:])
        if self.reduce == "max":
            pooled = heads.masked_max(point_embeds, mask)
        else:
            m = mask[..., None].to(point_embeds.dtype)
            pooled = (point_embeds * m).sum(1) / m.sum(1).clamp(min=1.0)
        h = self._fc1(self.action_mlp_fc1, pooled, te, (B, L, hidden))
        act = self.action_mlp_fc2(dropout(h, self.dropout, self.training,
                                          rng))
        xr = rotation_output(act, self.rot_pred_type, self.euler_bins)
        return xt, xr, act[..., -2], act[..., -1]


class MotionPlanner(Conditioned):
    """MotionPlannerPTV3CA / AdaNorm (`variant` 'ca', 'adanorm'): the
    action text (and the gripper pose under use_ee_pose; step ids are not
    read) conditions the backbone; the point labels enter at the stem."""

    def __init__(self, ptv3_cfg, act_cfg, generator, variant="ca"):
        super().__init__()
        ac = act_cfg
        labels = ac.get("pc_label_channels", 16)
        self.pc_label_embedding = embedding(4, labels, generator)
        self._init_context(ac, variant, generator, step_ids=False)
        self.ptv3_model = backbone(ptv3_cfg, ac, variant, generator,
                                   stem_categorical_channels=labels)
        hidden = list(ptv3_cfg["dec_channels"])[0]
        self.act_proj_head = TrajActionHead(
            generator, hidden, reduce=ac.get("reduce", "max"),
            pos_pred_type=ac.get("pos_pred_type", "heatmap_disc"),
            rot_pred_type=ac.get("rot_pred_type", "euler_disc"),
            hidden_size=hidden, dim_actions=ac.get("dim_actions", 7),
            max_traj_len=ac.get("max_traj_len", 5),
            traj_embed_size=ac.get("traj_embed_size", 64),
            dropout=ac.get("dropout", 0.0),
            euler_resolution=ac.get("euler_resolution", 5),
            pos_bins=ac.get("pos_bins", 50))
        self.pos_heatmap_temp = ac.get("pos_heatmap_temp", 1.0)

    def forward(self, batch, rng=None):
        """rng: the Randomness of a train-mode forward."""
        pc = batch["pc_fts"]
        ctx, ctx_mask = self._context(batch)
        vec = None
        if self.variant != "ca":
            vec, ctx = ctx, None
        categorical = (batch["pc_labels"].long(),
                       self.pc_label_embedding.weight)
        outs = self.ptv3_model(pc[..., :3], pc, batch["pc_mask"],
                               batch["pc_counts"], ctx, ctx_mask, rng,
                               stem_categorical=categorical,
                               order_perm=batch.get("order_perm"),
                               context_vec=vec)
        final = outs[-1]
        xt, xr, xo, xstop = self.act_proj_head(
            final["feat"], final["mask"], final["coord"],
            self.pos_heatmap_temp, rng)
        return {"pos": xt, "rot": xr, "open": xo, "stop": xstop,
                "final_coord": final["coord"], "final_mask": final["mask"],
                "sort0": outs[0]["sort0"],
                "pool_overflow": outs[0]["pool_overflow"]}


def _masked_bce(logits, targets, mask):
    per = torch.relu(logits) - logits * targets + \
        torch.log1p(torch.exp(-logits.abs()))
    return (per * mask).sum() / dist.global_count(mask.sum()).clamp(min=1.0)


def compute_mp_loss(preds, batch, act_cfg, loss_cfg):
    """The JAX compute_mp_loss: the position loss (heatmap_disc: per-step
    cross-entropy against the device-built targets, averaged over each
    cloud's valid steps, then over the valid clouds; heatmap_mlp: squared
    error over the valid steps), the rotation loss of the rot_pred_type
    (euler_disc bin cross-entropy; quat: the squared error of q or -q, the
    smaller; else squared error), openness and stop BCE over the valid
    steps. Pad clouds (batch_valid False) drop out of every term. The
    counts of clouds and steps are those of every process's batch in a
    process group (parallel/dist.py global_count), so that the processes'
    losses add up to the whole batch's; pool_overflow is reported, never
    part of total."""
    gt = batch["gt_trajs"]                                   # (B, L, 8)
    B = gt.shape[0]
    bv = batch.get("batch_valid")
    bv = gt.new_ones(B) if bv is None else bv.float()
    tmask = batch["traj_masks"].float() * bv[:, None]        # (B, L)
    steps = dist.global_count(tmask.sum()).clamp(min=1.0)
    tgt_pos, tgt_rot, tgt_open = gt[..., :3], gt[..., 3:-1], gt[..., -1]

    if act_cfg.get("pos_pred_type", "heatmap_disc") == "heatmap_disc":
        logits = preds["pos"]                                # (B, L, 3, N, nb)
        _, L, _, N, nb = logits.shape
        flat = logits.reshape(B, L, 3, N * nb)
        target = build_disc_pos_targets(batch, tgt_pos, nb // 2, act_cfg,
                                        preds)
        logp = F.log_softmax(flat, dim=-1)
        ce = -torch.where(target > 0, target * logp,
                          torch.zeros_like(logp)).sum(-1)     # (B, L, 3)
        w = tmask[:, :, None]
        per_cloud = (ce * w).sum((1, 2)) / w.sum((1, 2)).clamp(min=1.0)
        pos_loss = (per_cloud * bv).sum() / \
            dist.global_count(bv.sum()).clamp(min=1.0)
    else:
        se = (preds["pos"] - tgt_pos) ** 2
        pos_loss = (se * tmask[..., None]).sum() / steps / 3.0

    rot_type = act_cfg.get("rot_pred_type", "euler_disc")
    xr = preds["rot"]
    if rot_type == "euler_disc":
        labels = tgt_rot[..., :3].long()                     # (B, L, 3)
        logp = F.log_softmax(xr, dim=2)                      # (B, L, bins, 3)
        ce = -torch.gather(logp, 2, labels[:, :, None, :])[:, :, 0]
        rot_loss = (ce * tmask[..., None]).sum() / steps / 3.0
    elif rot_type == "quat":
        t = tgt_rot[..., :4]
        e = torch.minimum(((xr - t) ** 2).mean(-1), ((xr + t) ** 2).mean(-1))
        rot_loss = (e * tmask).sum() / steps
    else:
        se = (xr - tgt_rot[..., :xr.shape[-1]]) ** 2
        rot_loss = (se * tmask[..., None]).sum() / \
            (dist.global_count(tmask.sum()) * se.shape[-1]).clamp(min=1.0)

    open_loss = _masked_bce(preds["open"], tgt_open, tmask)
    stop_loss = _masked_bce(preds["stop"], batch["gt_trajs_stop"].float(),
                            tmask)
    total = loss_cfg.get("pos_weight", 1.0) * pos_loss + \
        loss_cfg.get("rot_weight", 1.0) * rot_loss + open_loss + stop_loss
    out = {"pos": pos_loss, "rot": rot_loss, "open": open_loss,
           "stop": stop_loss, "total": total}
    if "pool_overflow" in preds:
        out["pool_overflow"] = preds["pool_overflow"].float()
    return out


def decode_mp_actions(preds, act_cfg):
    """Head outputs -> (B, L, 9) [pos, quat xyzw, open logit, stop logit]
    on the device."""
    if act_cfg.get("pos_pred_type", "heatmap_disc") == "heatmap_disc":
        logits = preds["pos"]                                # (B, L, 3, N, nb)
        B, L, _, N, nb = logits.shape
        xyz = preds["final_coord"][:, None].expand(B, L, N, 3)
        mask = preds["final_mask"][:, None].expand(B, L, N)
        pos = best_pos_from_disc_logits(
            logits.reshape(B * L, 3, N, nb), xyz.reshape(B * L, N, 3),
            mask=mask.reshape(B * L, N),
            pos_bin_size=act_cfg.get("pos_bin_size", 0.01),
            pos_bins=act_cfg.get("pos_bins", 50),
            best=act_cfg.get("best_disc_pos", "max")).reshape(B, L, 3)
    else:
        pos = preds["pos"]
    quat = rotation_to_quat(preds["rot"], act_cfg, 2)
    return torch.cat([pos, quat, preds["open"][..., None],
                      preds["stop"][..., None]], dim=-1)
