"""3D-LOTUS++ motion planner, CA variant (port of
robot3dlotus_tpu/models/motion_planner.py `MotionPlannerTPU(variant='ca')`,
`TrajActionHead`, `compute_mp_loss` and `decode_mp_actions`).

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
  gt_trajs       (B, L, 8)  pos (3) + euler bins (3) + ... + open
  gt_trajs_stop  (B, L)
  traj_masks     (B, L) bool
The position targets are built on the device in the backbone's sorted
frame (build_disc_pos_targets); batches never carry disc_pos_probs.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import rotation as rotops
from ..ops.pos_codec import best_pos_from_disc_logits
from .layers import dense, dropout, trunc_normal_
from .ptv3 import PointTransformerV3
from .simple_policy import build_disc_pos_targets, ptv3_kwargs


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
    """heatmap_disc position per point and trajectory step, euler_disc
    rotation, openness and stop logits per step, from a masked max over
    points (the release configuration; the other types of the JAX head
    are not ported). fc1 of each MLP is factored over (points, steps): the
    per-point product is computed once and the per-step product added."""

    def __init__(self, generator, dim, reduce="max",
                 pos_pred_type="heatmap_disc", rot_pred_type="euler_disc",
                 hidden_size=128, max_traj_len=5, traj_embed_size=64,
                 dropout=0.0, euler_resolution=5, pos_bins=50):
        super().__init__()
        if (reduce, pos_pred_type, rot_pred_type) != \
                ("max", "heatmap_disc", "euler_disc"):
            raise NotImplementedError(
                f"TrajActionHead({reduce}, {pos_pred_type}, {rot_pred_type})"
                ": the port serves reduce=max, heatmap_disc, euler_disc")
        g = generator
        self.max_traj_len, self.pos_bins = max_traj_len, pos_bins
        self.dropout = dropout
        self.euler_bins = 360 // euler_resolution
        E = traj_embed_size
        if E > 0:
            self.traj_embedding = nn.Embedding(max_traj_len, E)
            with torch.no_grad():
                trunc_normal_(self.traj_embedding.weight, g)
        self.heatmap_mlp_fc1 = _SplitDense(dim, E, hidden_size, g)
        self.heatmap_mlp_fc2 = dense(hidden_size, 3 * pos_bins * 2, g)
        self.action_mlp_fc1 = _SplitDense(dim, E, hidden_size, g)
        self.action_mlp_fc2 = dense(hidden_size, self.euler_bins * 3 + 2, g)

    def _fc1(self, fc1, x, te, shape):
        """fc1(concat(x, te)) broadcast to `shape` (..., L, hidden)."""
        ya, yb = fc1(x, te)
        h = ya[..., None, :] + fc1.bias
        h = h.expand(shape) if yb is None else h + yb
        return F.leaky_relu(h, negative_slope=0.02)

    def forward(self, point_embeds, mask, rng=None):
        """point_embeds (B, N, D); mask (B, N). Returns
        xt (B, L, 3, N, 2*pos_bins) logits, xr (B, L, euler_bins, 3)
        logits, xo (B, L) openness and xstop (B, L) stop logits."""
        B, N, _ = point_embeds.shape
        L, nb = self.max_traj_len, 2 * self.pos_bins
        hidden = self.heatmap_mlp_fc2.in_features
        te = self.traj_embedding.weight if hasattr(
            self, "traj_embedding") else None
        h = self._fc1(self.heatmap_mlp_fc1, point_embeds, te,
                      (B, N, L, hidden))
        ht = self.heatmap_mlp_fc2(dropout(h, self.dropout, self.training,
                                          rng))
        # 'n t (c b) -> t c n b' per cloud, padded points out of the softmax
        xt = ht.reshape(B, N, L, 3, nb).permute(0, 2, 3, 1, 4)
        xt = torch.where(mask[:, None, None, :, None], xt,
                         torch.full_like(xt, -1e9))
        pooled = torch.where(mask[..., None], point_embeds,
                             torch.full_like(point_embeds, -float("inf"))
                             ).amax(dim=1)
        h = self._fc1(self.action_mlp_fc1, pooled, te, (B, L, hidden))
        act = self.action_mlp_fc2(dropout(h, self.dropout, self.training,
                                          rng))
        xr = act[..., :self.euler_bins * 3].reshape(B, L, self.euler_bins, 3)
        return xt, xr, act[..., -2], act[..., -1]


class MotionPlanner(nn.Module):
    """MotionPlannerPTV3CA: the action-text tokens condition the backbone
    through the cross-attention blocks; the point labels enter at the
    stem."""

    def __init__(self, ptv3_cfg, act_cfg, generator):
        super().__init__()
        ac = act_cfg
        if ac.get("use_ee_pose") or ac.get("use_step_id"):
            raise NotImplementedError("pose/step context tokens are not "
                                      "ported yet")
        ctx = ac["context_channels"]
        labels = ac.get("pc_label_channels", 16)
        self.pc_label_embedding = nn.Embedding(4, labels)
        with torch.no_grad():
            trunc_normal_(self.pc_label_embedding.weight, generator)
        self.txt_fc = dense(ac.get("txt_ft_size", 512), ctx, generator)
        self.ptv3_model = PointTransformerV3(
            generator, context_channels=ctx,
            grid_size=ac.get("voxel_size", 0.01),
            stem_categorical_channels=labels, **ptv3_kwargs(ptv3_cfg))
        hidden = list(ptv3_cfg["dec_channels"])[0]
        self.act_proj_head = TrajActionHead(
            generator, hidden, reduce=ac.get("reduce", "max"),
            pos_pred_type=ac.get("pos_pred_type", "heatmap_disc"),
            rot_pred_type=ac.get("rot_pred_type", "euler_disc"),
            hidden_size=hidden, max_traj_len=ac.get("max_traj_len", 5),
            traj_embed_size=ac.get("traj_embed_size", 64),
            dropout=ac.get("dropout", 0.0),
            euler_resolution=ac.get("euler_resolution", 5),
            pos_bins=ac.get("pos_bins", 50))

    def forward(self, batch, rng=None):
        """rng: the Randomness of a train-mode forward."""
        pc = batch["pc_fts"]
        context = self.txt_fc(batch["txt_embeds"])
        categorical = (batch["pc_labels"].long(),
                       self.pc_label_embedding.weight)
        outs = self.ptv3_model(pc[..., :3], pc, batch["pc_mask"],
                               batch["pc_counts"], context, batch["txt_mask"],
                               rng, stem_categorical=categorical,
                               order_perm=batch.get("order_perm"))
        final = outs[-1]
        xt, xr, xo, xstop = self.act_proj_head(final["feat"], final["mask"],
                                               rng)
        return {"pos": xt, "rot": xr, "open": xo, "stop": xstop,
                "final_coord": final["coord"], "final_mask": final["mask"],
                "sort0": outs[0]["sort0"],
                "pool_overflow": outs[0]["pool_overflow"]}


def _masked_bce(logits, targets, mask):
    per = torch.relu(logits) - logits * targets + \
        torch.log1p(torch.exp(-logits.abs()))
    return (per * mask).sum() / mask.sum().clamp(min=1.0)


def compute_mp_loss(preds, batch, act_cfg, loss_cfg):
    """The JAX compute_mp_loss for heatmap_disc / euler_disc: per-step
    position cross-entropy against the device-built targets (averaged over
    each cloud's valid steps, then over the valid clouds), rotation-bin
    cross-entropy, openness and stop BCE over the valid steps. Pad clouds
    (batch_valid False) drop out of every term; pool_overflow is reported,
    never part of total."""
    gt = batch["gt_trajs"]                                   # (B, L, 8)
    B = gt.shape[0]
    bv = batch.get("batch_valid")
    bv = gt.new_ones(B) if bv is None else bv.float()
    tmask = batch["traj_masks"].float() * bv[:, None]        # (B, L)
    tgt_pos, tgt_rot, tgt_open = gt[..., :3], gt[..., 3:-1], gt[..., -1]

    logits = preds["pos"]                                    # (B, L, 3, N, nb)
    _, L, _, N, nb = logits.shape
    flat = logits.reshape(B, L, 3, N * nb)
    target = build_disc_pos_targets(batch, tgt_pos, nb // 2, act_cfg, preds)
    logp = F.log_softmax(flat, dim=-1)
    ce = -torch.where(target > 0, target * logp,
                      torch.zeros_like(logp)).sum(-1)         # (B, L, 3)
    w = tmask[:, :, None]
    per_cloud = (ce * w).sum((1, 2)) / w.sum((1, 2)).clamp(min=1.0)
    pos_loss = (per_cloud * bv).sum() / bv.sum().clamp(min=1.0)

    labels = tgt_rot[..., :3].long()                         # (B, L, 3)
    logp = F.log_softmax(preds["rot"], dim=2)                # (B, L, bins, 3)
    ce = -torch.gather(logp, 2, labels[:, :, None, :])[:, :, 0]
    rot_loss = (ce * tmask[..., None]).sum() / \
        tmask.sum().clamp(min=1.0) / 3.0

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
    logits = preds["pos"]                                    # (B, L, 3, N, nb)
    B, L, _, N, nb = logits.shape
    xyz = preds["final_coord"][:, None].expand(B, L, N, 3)
    mask = preds["final_mask"][:, None].expand(B, L, N)
    pos = best_pos_from_disc_logits(
        logits.reshape(B * L, 3, N, nb), xyz.reshape(B * L, N, 3),
        mask=mask.reshape(B * L, N),
        pos_bin_size=act_cfg.get("pos_bin_size", 0.01),
        pos_bins=act_cfg.get("pos_bins", 50),
        best=act_cfg.get("best_disc_pos", "max")).reshape(B, L, 3)
    bins = torch.argmax(preds["rot"], dim=2)                 # (B, L, 3)
    quat = rotops.discrete_euler_to_quat(
        bins, act_cfg.get("euler_resolution", 5))
    return torch.cat([pos, quat, preds["open"][..., None],
                      preds["stop"][..., None]], dim=-1)
