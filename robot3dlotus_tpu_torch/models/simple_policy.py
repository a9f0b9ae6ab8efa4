"""3D-LOTUS keystep policy, CA variant, eval path (port of
robot3dlotus_tpu/models/simple_policy.py `SimplePolicyTPU(variant='ca')`
and `decode_actions`).

Batch layout (static shapes, masked):
  pc_fts      (B, N, Cin)  xyz + rgb (+ height), xyz first
  pc_mask     (B, N) bool
  pc_counts   (B,) int
  txt_embeds  (B, T, txt_ft)
  txt_mask    (B, T) bool
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import rotation as rotops
from ..ops.pos_codec import best_pos_from_disc_logits
from .heads import ActionHead
from .layers import dense
from .ptv3 import PointTransformerV3

_PTV3_FIELDS = {
    "in_channels", "orders", "enc_depths", "enc_channels", "enc_num_head",
    "enc_patch_size", "dec_depths", "dec_channels", "dec_num_head",
    "dec_patch_size", "mlp_ratio", "qkv_bias", "qk_scale", "qk_norm",
    "serial_depth", "stem_kernel", "lookup_extent", "assume_sorted",
    "stage_caps",
}
# options that do not change the eval forward of this port: dropout and
# drop-path rates (inference only), order shuffling (never at eval here),
# norm plumbing resolved by the CA variant, the stride list (always 2),
# and the JAX package's engine and precision selectors
_PTV3_EVAL_IGNORED = {
    "attn_drop", "proj_drop", "drop_path", "shuffle_orders", "stride",
    "pre_norm", "upcast_softmax", "pdnorm_bn", "pdnorm_ln",
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
        elif k in _PTV3_EVAL_IGNORED:
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
            pos_bins=ac.get("pos_bins", 50))

    def forward(self, batch):
        pc = batch["pc_fts"]
        context = self.txt_fc(batch["txt_embeds"])
        outs = self.ptv3_model(pc[..., :3], pc, batch["pc_mask"],
                               batch["pc_counts"], context, batch["txt_mask"])
        final = outs[-1]
        xt, xr, xo = self.act_proj_head(final["feat"], final["mask"])
        return {"pos": xt, "rot": xr, "open": xo,
                "final_coord": final["coord"], "final_mask": final["mask"],
                "sort0": outs[0]["sort0"],
                "pool_overflow": outs[0]["pool_overflow"]}


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
