"""3D-LOTUS keystep policy (port of robot3dlotus_tpu/models/simple_policy.py
`SimplePolicyTPU`, `RobotPoseEmbedding`, `decode_actions`,
`build_disc_pos_targets` and `compute_loss`), in its three conditioning
variants:
  ca       SimplePolicyPTV3CA: the text tokens (and a pose and a step token
           when use_ee_pose / use_step_id) through cross-attention blocks;
  adanorm  SimplePolicyPTV3AdaNorm: a per-cloud context vector (the text
           tokens' mean, or an attention-weighted sum under txt_reduce
           'attn', plus the pose and step embeddings) modulating the norms
           (pdnorm_adaptive; without it the backbone is unconditioned);
  concat   SimplePolicyPTV3Concat: that vector appended to every point's
           features, so the stem conv reads in_channels + context_channels.

Batch layout (static shapes, masked):
  pc_fts      (B, N, Cin)  xyz + rgb (+ height), xyz first
  pc_mask     (B, N) bool
  pc_counts   (B,) int
  txt_embeds  (B, T, txt_ft)
  txt_mask    (B, T) bool
  ee_poses    (B, 8), step_ids (B,) int: read under use_ee_pose / use_step_id
and for the loss:
  gt_actions     (B, 3 + R + 1)  pos (3) + the rot_pred_type's target (euler
                 bins, quaternion, euler / 180, euler delta, rot6d) + open
  pc_robot_mask  (B, N) bool, optional: robot points get no position target
  batch_valid    (B,) bool, optional: padded clouds leave every loss term
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import rotation as rotops
from ..parallel import dist
from ..ops.pos_codec import best_pos_from_disc_logits, disc_pos_gt_prob
from .heads import ActionHead
from .layers import dense, trunc_normal_
from .ptv3 import PointTransformerV3

_PTV3_FIELDS = {
    "in_channels", "orders", "enc_depths", "enc_channels", "enc_num_head",
    "enc_patch_size", "dec_depths", "dec_channels", "dec_num_head",
    "dec_patch_size", "mlp_ratio", "qkv_bias", "qk_scale", "qk_norm",
    "serial_depth", "stem_kernel", "lookup_extent", "assume_sorted",
    "stage_caps", "attn_drop", "proj_drop", "drop_path", "shuffle_orders",
    "pdnorm_only_decoder", "compute_dtype", "upcast_attention",
    "scaled_cosine_attn", "enable_rpe", "add_coords_in_attn",
}
# options that do not change this port's model: norm plumbing resolved by
# the variant (pdnorm_adaptive is read by the AdaNorm variant itself), the
# stride list (always 2), and the JAX package's engine and precision
# selectors
_PTV3_IGNORED = {
    "stride", "pre_norm", "upcast_softmax", "pdnorm_bn", "pdnorm_ln",
    "pdnorm_decouple", "pdnorm_adaptive", "pdnorm_affine",
    "pdnorm_conditions", "pdnorm_context_channels", "enable_flash",
    "cls_mode", "attn_impl", "conv_impl", "conv_halo", "conv_far_per_tap",
    "remat",
}


def ptv3_kwargs(cfg):
    """ptv3_config dict -> PointTransformerV3 kwargs. Raises on a truthy
    option the port does not know rather than silently computing another
    model."""
    out = {}
    for k, v in cfg.items():
        if k in ("order", "orders"):
            out["orders"] = tuple(v)
        elif k in _PTV3_FIELDS:
            out[k] = tuple(v) if isinstance(v, list) else v
        elif k in _PTV3_IGNORED:
            continue
        elif v:
            raise ValueError(
                f"ptv3_config option {k}={v!r} is not implemented by the "
                f"PyTorch port")
    return out


def embedding(num, dim, generator):
    """nn.Embedding with the JAX package's truncated normal (std 0.02)."""
    emb = nn.Embedding(num, dim)
    with torch.no_grad():
        trunc_normal_(emb.weight, generator)
    return emb


class RobotPoseEmbedding(nn.Module):
    """The gripper pose (B, 8) [pos, quat xyzw, open] -> (B, hidden): a
    linear position term, an open-state embedding, a linear term of the
    euler angles' sines and cosines (on the device), layer-normed at eps
    1e-12."""

    def __init__(self, hidden, generator):
        super().__init__()
        self.pos_embedding = dense(3, hidden, generator)
        self.open_embedding = embedding(2, hidden, generator)
        self.rot_embedding = dense(6, hidden, generator)
        self.layer_norm = nn.LayerNorm(hidden, eps=1e-12)

    def forward(self, actions):
        euler = rotops.quat_to_euler(actions[..., 3:7])      # radians
        rot = self.rot_embedding(torch.cat([torch.sin(euler),
                                            torch.cos(euler)], -1))
        return self.layer_norm(self.pos_embedding(actions[..., :3]) + rot +
                               self.open_embedding(actions[..., -1].long()))


class Conditioned(nn.Module):
    """The conditioning inputs of both model families, held at the model's
    top level under the flax names: txt_fc on the text tokens, the pose
    (use_ee_pose) and step (use_step_id) embeddings, and for the non-CA
    variants txt_attn_fc (txt_reduce 'attn')."""

    def _init_context(self, act_cfg, variant, generator, step_ids=True):
        ac, g = act_cfg, generator
        ctx = ac["context_channels"]
        self.variant = variant
        self.txt_fc = dense(ac.get("txt_ft_size", 512), ctx, g)
        self.attn_reduce = variant != "ca" and \
            ac.get("txt_reduce", "mean") == "attn"
        if self.attn_reduce:
            self.txt_attn_fc = dense(ac.get("txt_ft_size", 512), 1, g)
        if ac.get("use_ee_pose", False):
            self.pose_embedding = RobotPoseEmbedding(ctx, g)
        if step_ids and ac.get("use_step_id", False):
            self.stepid_embedding = embedding(ac.get("max_steps", 30), ctx, g)

    def _context(self, batch):
        """-> (context tokens, their mask) under CA; else (the context
        vector, None): the valid tokens' mean, or under txt_reduce 'attn'
        their sum weighted by a softmax of txt_attn_fc on the raw
        embeddings; plus the pose and step embeddings."""
        txt, tmask = batch["txt_embeds"], batch["txt_mask"]
        txt_ctx = self.txt_fc(txt)
        extra = []
        if hasattr(self, "pose_embedding"):
            extra.append(self.pose_embedding(batch["ee_poses"]))
        if hasattr(self, "stepid_embedding"):
            extra.append(self.stepid_embedding(batch["step_ids"].long()))
        if self.variant == "ca":
            toks = torch.cat([txt_ctx] + [e[:, None] for e in extra], 1)
            mask = torch.cat([tmask] + [tmask.new_ones(tmask.shape[0], 1)
                                        for _ in extra], 1)
            return toks, mask
        if self.attn_reduce:
            w = self.txt_attn_fc(txt)[..., 0]
            w = torch.softmax(torch.where(tmask, w, torch.full_like(w, -1e9)),
                              dim=-1)
            vec = torch.einsum("bt,btc->bc", w, txt_ctx)
        else:
            m = tmask[..., None].to(txt_ctx.dtype)
            vec = (txt_ctx * m).sum(1) / m.sum(1).clamp(min=1.0)
        for e in extra:
            vec = vec + e
        return vec, None


def backbone(ptv3_cfg, act_cfg, variant, generator, **kw):
    """The variant's PointTransformerV3: cross-attention blocks under CA,
    adaptive norms under AdaNorm with pdnorm_adaptive (default True), the
    context vector's channels added to the stem's input under Concat."""
    kwargs = ptv3_kwargs(ptv3_cfg)
    ctx = act_cfg["context_channels"]
    if variant == "concat":
        kwargs["in_channels"] = kwargs.get("in_channels", 7) + ctx
    return PointTransformerV3(
        generator, context_channels=ctx, use_cross_attn=variant == "ca",
        norm_adaptive=variant == "adanorm" and ptv3_cfg.get(
            "pdnorm_adaptive", True),
        grid_size=act_cfg.get("voxel_size", 0.01), **kwargs, **kw)


class SimplePolicy(Conditioned):
    """SimplePolicyPTV3CA / AdaNorm / Concat (`variant` 'ca', 'adanorm',
    'concat')."""

    def __init__(self, ptv3_cfg, act_cfg, generator, variant="ca"):
        super().__init__()
        ac = act_cfg
        self._init_context(ac, variant, generator)
        self.ptv3_model = backbone(ptv3_cfg, ac, variant, generator)
        self.act_proj_head = ActionHead(
            generator, reduce=ac.get("reduce", "max"),
            pos_pred_type=ac.get("pos_pred_type", "heatmap_disc"),
            rot_pred_type=ac.get("rot_pred_type", "euler_disc"),
            hidden_size=list(ptv3_cfg["dec_channels"])[0],
            dim_actions=ac.get("dim_actions", 7),
            euler_resolution=ac.get("euler_resolution", 5),
            pos_bins=ac.get("pos_bins", 50), dropout=ac.get("dropout", 0.0))
        self.pos_heatmap_temp = ac.get("pos_heatmap_temp", 1.0)

    def forward(self, batch, rng=None):
        """rng: the Randomness of a train-mode forward (dropout, attention
        dropout, order shuffling), or of a shuffled eval-mode one."""
        pc = batch["pc_fts"]
        ctx, ctx_mask = self._context(batch)
        feat, vec = pc, None
        if self.variant != "ca":
            vec, ctx = ctx, None
            if self.variant == "concat":
                feat = torch.cat([pc, vec[:, None].expand(
                    -1, pc.shape[1], -1)], -1)
        outs = self.ptv3_model(pc[..., :3], feat, batch["pc_mask"],
                               batch["pc_counts"], ctx, ctx_mask, rng,
                               order_perm=batch.get("order_perm"),
                               context_vec=vec if self.variant == "adanorm"
                               else None)
        final = outs[-1]
        xt, xr, xo = self.act_proj_head(final["feat"], final["mask"],
                                        final["coord"],
                                        self.pos_heatmap_temp, rng)
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
    """The JAX compute_loss: the position loss (heatmap_disc: per-axis
    cross-entropy against the disc targets; heatmap_mlp: squared error),
    the rotation loss of the rot_pred_type (euler_disc: per-axis bin
    cross-entropy; quat: the squared error of q or -q, the smaller; euler:
    of t or its wrapped twin, per axis the smaller; euler_delta / rot6d:
    squared error) and the openness BCE, each averaged over the valid
    clouds (batch_valid): in a process group over every process's
    (parallel/dist.py global_count), so that the processes' losses add up
    to the whole batch's. pool_overflow is reported, never part of
    total."""
    gt = batch["gt_actions"]
    tgt_pos, tgt_rot, tgt_open = gt[:, :3], gt[:, 3:-1], gt[:, -1]
    B = gt.shape[0]
    bv = batch.get("batch_valid")
    bv = gt.new_ones(B) if bv is None else bv.float()
    nvalid = dist.global_count(bv.sum()).clamp(min=1.0)

    def bmean(per_cloud):
        return (per_cloud * bv).sum() / nvalid

    if act_cfg.get("pos_pred_type", "heatmap_disc") == "heatmap_disc":
        logits = preds["pos"]                                # (B, 3, N, nb)
        _, _, N, nb = logits.shape
        target = build_disc_pos_targets(batch, tgt_pos, nb // 2, act_cfg,
                                        preds)
        logp = F.log_softmax(logits.reshape(B, 3, N * nb), dim=-1)
        pos_loss = -torch.where(target > 0, target * logp,
                                torch.zeros_like(logp)).sum(-1)
        pos_loss = bmean(pos_loss.mean(-1))
    else:
        pos_loss = bmean(((preds["pos"] - tgt_pos) ** 2).mean(-1))

    rot_type = act_cfg.get("rot_pred_type", "euler_disc")
    xr = preds["rot"]
    if rot_type == "euler_disc":
        labels = tgt_rot[:, :3].long()                       # (B, 3) bins
        logp = F.log_softmax(xr, dim=1)                      # (B, bins, 3)
        rot_loss = bmean(-torch.gather(logp, 1, labels[:, None, :])[:, 0]
                         .mean(-1))
    elif rot_type == "quat":
        t = tgt_rot[:, :4]
        rot_loss = bmean(torch.minimum(((xr - t) ** 2).mean(-1),
                                       ((xr + t) ** 2).mean(-1)))
    elif rot_type == "euler":
        t = tgt_rot[:, :3]
        t_alt = torch.where(t < 0, t + 2, torch.where(t > 0, t - 2, t))
        rot_loss = bmean(torch.minimum((xr - t) ** 2,
                                       (xr - t_alt) ** 2).mean(-1))
    else:   # euler_delta, rot6d (the dataset converts the target)
        rot_loss = bmean(((xr - tgt_rot[:, :xr.shape[-1]]) ** 2).mean(-1))

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


def rotation_to_quat(xr, act_cfg, bin_dim):
    """The rotation head's output -> xyzw quaternions: euler_disc's argmax
    bins over `bin_dim`, quat as it is, rot6d through its matrix, euler and
    euler_delta as normalised angles (x 180 degrees)."""
    rot_type = act_cfg.get("rot_pred_type", "euler_disc")
    if rot_type == "euler_disc":
        return rotops.discrete_euler_to_quat(
            torch.argmax(xr, dim=bin_dim), act_cfg.get("euler_resolution", 5))
    if rot_type == "quat":
        return xr
    if rot_type == "rot6d":
        return rotops.matrix_to_quat(rotops.rot6d_to_matrix(xr))
    return rotops.euler_to_quat(xr * 180.0, degrees=True)


def decode_actions(preds, act_cfg):
    """Head outputs -> (B, 8) [pos, quat xyzw, open logit] on the device."""
    if act_cfg.get("pos_pred_type", "heatmap_disc") == "heatmap_disc":
        pos = best_pos_from_disc_logits(
            preds["pos"], preds["final_coord"], mask=preds["final_mask"],
            pos_bin_size=act_cfg.get("pos_bin_size", 0.01),
            pos_bins=act_cfg.get("pos_bins", 50),
            best=act_cfg.get("best_disc_pos", "max"))
    else:
        pos = preds["pos"]
    quat = rotation_to_quat(preds["rot"], act_cfg, 1)
    return torch.cat([pos, quat, preds["open"][..., None]], dim=-1)
