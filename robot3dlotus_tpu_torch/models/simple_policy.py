"""3D-LOTUS keystep policy, CA variant (port of
robot3dlotus_tpu/models/simple_policy.py `SimplePolicyTPU(variant='ca')`,
`decode_actions`, `build_disc_pos_targets` and `compute_loss`).

Batch layout (static shapes, masked):
  pc_fts      (B, N, Cin)  xyz + rgb (+ height), xyz first
  pc_mask     (B, N) bool
  pc_counts   (B,) int
  txt_embeds  (B, T, txt_ft)
  txt_mask    (B, T) bool
and for the loss:
  gt_actions     (B, 7)  pos (3) + euler bins (3) + open
  pc_robot_mask  (B, N) bool, optional: robot points get no position target
  batch_valid    (B,) bool, optional: padded clouds leave every loss term
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import rotation as rotops
from ..ops.pos_codec import best_pos_from_disc_logits, disc_pos_gt_prob
from .heads import ActionHead
from .layers import dense
from .ptv3 import PointTransformerV3

_PTV3_FIELDS = {
    "in_channels", "orders", "enc_depths", "enc_channels", "enc_num_head",
    "enc_patch_size", "dec_depths", "dec_channels", "dec_num_head",
    "dec_patch_size", "mlp_ratio", "qkv_bias", "qk_scale", "qk_norm",
    "serial_depth", "stem_kernel", "lookup_extent", "assume_sorted",
    "stage_caps", "attn_drop", "proj_drop", "drop_path", "shuffle_orders",
}
# options that do not change this port's model: norm plumbing resolved by
# the CA variant, the stride list (always 2), and the JAX package's engine
# and precision selectors
_PTV3_IGNORED = {
    "stride", "pre_norm", "upcast_softmax", "pdnorm_bn", "pdnorm_ln",
    "pdnorm_decouple", "pdnorm_adaptive", "pdnorm_affine",
    "pdnorm_conditions", "pdnorm_context_channels", "enable_flash",
    "cls_mode", "attn_impl", "conv_impl", "conv_halo", "conv_far_per_tap",
    "remat",
}


def ptv3_kwargs(cfg):
    """ptv3_config dict -> PointTransformerV3 kwargs. Raises on a truthy
    option the port does not implement (compute_dtype, rpe, ...) rather
    than silently computing another model."""
    out = {}
    for k, v in cfg.items():
        if k in ("order", "orders"):
            out["orders"] = tuple(v)
        elif k in _PTV3_FIELDS:
            out[k] = tuple(v) if isinstance(v, list) else v
        elif k in _PTV3_IGNORED:
            continue
        elif v:
            raise ValueError(f"ptv3_config option {k}={v!r} is not "
                             "implemented by the PyTorch port")
    return out


class SimplePolicy(nn.Module):
    """SimplePolicyPTV3CA: text tokens condition the backbone through the
    cross-attention blocks."""

    def __init__(self, ptv3_cfg, act_cfg, generator):
        super().__init__()
        ac = act_cfg
        if ac.get("use_ee_pose") or ac.get("use_step_id"):
            raise NotImplementedError("pose/step context tokens are not "
                                      "ported yet")
        ctx = ac["context_channels"]
        self.txt_fc = dense(ac.get("txt_ft_size", 512), ctx, generator)
        self.ptv3_model = PointTransformerV3(
            generator, context_channels=ctx,
            grid_size=ac.get("voxel_size", 0.01),
            **ptv3_kwargs(ptv3_cfg))
        self.act_proj_head = ActionHead(
            generator, reduce=ac.get("reduce", "max"),
            pos_pred_type=ac.get("pos_pred_type", "heatmap_disc"),
            rot_pred_type=ac.get("rot_pred_type", "euler_disc"),
            hidden_size=list(ptv3_cfg["dec_channels"])[0],
            euler_resolution=ac.get("euler_resolution", 5),
            pos_bins=ac.get("pos_bins", 50), dropout=ac.get("dropout", 0.0))

    def forward(self, batch, rng=None):
        """rng: the Randomness of a train-mode forward (dropout, attention
        dropout, order shuffling)."""
        pc = batch["pc_fts"]
        context = self.txt_fc(batch["txt_embeds"])
        outs = self.ptv3_model(pc[..., :3], pc, batch["pc_mask"],
                               batch["pc_counts"], context, batch["txt_mask"],
                               rng, order_perm=batch.get("order_perm"))
        final = outs[-1]
        xt, xr, xo = self.act_proj_head(final["feat"], final["mask"], rng)
        return {"pos": xt, "rot": xr, "open": xo,
                "final_coord": final["coord"], "final_mask": final["mask"],
                "sort0": outs[0]["sort0"],
                "pool_overflow": outs[0]["pool_overflow"]}


def build_disc_pos_targets(batch, gt_pos, pos_bins, act_cfg, preds):
    """(B, 3, N * 2 * pos_bins) position targets in the backbone's sorted
    frame (or (B, L, 3, N * 2 * pos_bins) for trajectory positions gt_pos
    (B, L, 3)): built from final_coord / final_mask, with the robot mask
    carried into that frame by sort0."""
    robot = batch.get("pc_robot_mask")
    if robot is not None:
        robot = torch.gather(robot, 1, preds["sort0"])
    return disc_pos_gt_prob(
        preds["final_coord"], preds["final_mask"], gt_pos, robot_mask=robot,
        pos_bin_size=act_cfg.get("pos_bin_size", 0.01), pos_bins=pos_bins,
        heatmap_type=act_cfg.get("pos_heatmap_type", "dist"))


def compute_loss(preds, batch, act_cfg, loss_cfg):
    """The JAX compute_loss for heatmap_disc / euler_disc: per-axis
    position cross-entropy against the disc targets, per-axis rotation-bin
    cross-entropy and the openness BCE, each averaged over the valid clouds
    (batch_valid). pool_overflow is reported, never part of total."""
    gt = batch["gt_actions"]
    tgt_pos, tgt_rot, tgt_open = gt[:, :3], gt[:, 3:-1], gt[:, -1]
    B = gt.shape[0]
    bv = batch.get("batch_valid")
    bv = gt.new_ones(B) if bv is None else bv.float()
    nvalid = bv.sum().clamp(min=1.0)

    def bmean(per_cloud):
        return (per_cloud * bv).sum() / nvalid

    logits = preds["pos"]                                    # (B, 3, N, nb)
    _, _, N, nb = logits.shape
    target = build_disc_pos_targets(batch, tgt_pos, nb // 2, act_cfg, preds)
    logp = F.log_softmax(logits.reshape(B, 3, N * nb), dim=-1)
    pos_loss = -torch.where(target > 0, target * logp,
                            torch.zeros_like(logp)).sum(-1)
    pos_loss = bmean(pos_loss.mean(-1))

    labels = tgt_rot[:, :3].long()                           # (B, 3) bins
    logp = F.log_softmax(preds["rot"], dim=1)                # (B, bins, 3)
    rot_loss = bmean(-torch.gather(logp, 1, labels[:, None, :])[:, 0].mean(-1))

    x = preds["open"]
    open_loss = bmean(torch.relu(x) - x * tgt_open +
                      torch.log1p(torch.exp(-x.abs())))

    total = loss_cfg.get("pos_weight", 1.0) * pos_loss + \
        loss_cfg.get("rot_weight", 1.0) * rot_loss + open_loss
    out = {"pos": pos_loss, "rot": rot_loss, "open": open_loss,
           "total": total}
    if "pool_overflow" in preds:
        out["pool_overflow"] = preds["pool_overflow"].float()
    return out


def decode_actions(preds, act_cfg):
    """Head outputs -> (B, 8) [pos, quat xyzw, open logit] on the device."""
    pos = best_pos_from_disc_logits(
        preds["pos"], preds["final_coord"], mask=preds["final_mask"],
        pos_bin_size=act_cfg.get("pos_bin_size", 0.01),
        pos_bins=act_cfg.get("pos_bins", 50),
        best=act_cfg.get("best_disc_pos", "max"))
    bins = torch.argmax(preds["rot"], dim=1)                      # (B, 3)
    quat = rotops.discrete_euler_to_quat(
        bins, act_cfg.get("euler_resolution", 5))
    return torch.cat([pos, quat, preds["open"][..., None]], dim=-1)
