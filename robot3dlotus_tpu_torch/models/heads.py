"""3D-LOTUS action head (port of robot3dlotus_tpu/models/heads.py
`ActionHead`): a position head over the points, a rotation and openness
head over a reduction of them; in train mode each MLP drops its hidden
layer at `dropout`.

  pos_pred_type  heatmap_disc: per point, axis and bin logits;
                 heatmap_mlp: a temperature softmax over the points of an
                 offset coordinate each, (B, 3)
  reduce         max / mean over the valid points, or attn: a per-point
                 MLP whose first output weighs a softmax over the points
  rot_pred_type  euler_disc (bin logits), quat (normalised), rot6d, euler,
                 euler_delta
Every softmax and reduction is masked to the valid points.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import dense, dropout

ROT_DIMS = {"quat": 4, "rot6d": 6, "euler": 3, "euler_delta": 3}


class ActionHead(nn.Module):
    def __init__(self, generator, reduce="max", pos_pred_type="heatmap_disc",
                 rot_pred_type="euler_disc", hidden_size=128, dim_actions=7,
                 euler_resolution=5, pos_bins=50, dropout=0.0):
        super().__init__()
        if pos_pred_type not in ("heatmap_disc", "heatmap_mlp"):
            raise NotImplementedError(pos_pred_type)
        if reduce not in ("max", "mean", "attn"):
            raise NotImplementedError(reduce)
        if rot_pred_type != "euler_disc" and rot_pred_type not in ROT_DIMS:
            raise NotImplementedError(rot_pred_type)
        self.reduce, self.pos_pred_type = reduce, pos_pred_type
        self.rot_pred_type = rot_pred_type
        self.pos_bins, self.dropout = pos_bins, dropout
        self.euler_bins = 360 // euler_resolution
        act_out = self.euler_bins * 3 + 1 if rot_pred_type == "euler_disc" \
            else dim_actions - 3
        g = generator
        pos_out = 3 * pos_bins * 2 if pos_pred_type == "heatmap_disc" else 4
        self.heatmap_mlp_fc1 = dense(hidden_size, hidden_size, g)
        self.heatmap_mlp_fc2 = dense(hidden_size, pos_out, g)
        self.action_mlp_fc1 = dense(hidden_size, hidden_size, g)
        self.action_mlp_fc2 = dense(hidden_size, act_out + (
            reduce == "attn"), g)

    def _mlp(self, fc1, fc2, x, rng):
        x = F.leaky_relu(fc1(x), negative_slope=0.02)
        return fc2(dropout(x, self.dropout, self.training, rng))

    def forward(self, point_embeds, mask, coords=None, temp=1.0, rng=None):
        """point_embeds (B, N, D); mask (B, N); coords (B, N, 3), read by
        heatmap_mlp. Returns xt: (B, 3, N, 2*pos_bins) logits (heatmap_disc)
        or (B, 3) coordinates (heatmap_mlp); xr: (B, euler_bins, 3) logits
        (euler_disc) or (B, dim); xo: (B,) openness logit."""
        B, N, _ = point_embeds.shape
        ht = self._mlp(self.heatmap_mlp_fc1, self.heatmap_mlp_fc2,
                       point_embeds, rng)
        if self.pos_pred_type == "heatmap_disc":
            # 'n (c b) -> c n b', then mask padded points out of the softmax
            xt = ht.reshape(B, N, 3, 2 * self.pos_bins).permute(0, 2, 1, 3)
            xt = torch.where(mask[:, None, :, None], xt,
                             torch.full_like(xt, -1e9))
        else:
            w = _masked_softmax(ht[..., 0] / temp, mask)
            xt = torch.einsum("bn,bnc->bc", w, coords + ht[..., 1:])

        if self.reduce == "attn":
            per_point = self._mlp(self.action_mlp_fc1, self.action_mlp_fc2,
                                  point_embeds, rng)
            w = _masked_softmax(per_point[..., 0] / temp, mask)
            act = torch.einsum("bn,bnd->bd", w, per_point[..., 1:])
        else:
            if self.reduce == "max":
                pooled = torch.where(
                    mask[..., None], point_embeds,
                    torch.full_like(point_embeds, -float("inf"))).amax(dim=1)
            else:
                m = mask[..., None].to(point_embeds.dtype)
                pooled = (point_embeds * m).sum(1) / m.sum(1).clamp(min=1.0)
            act = self._mlp(self.action_mlp_fc1, self.action_mlp_fc2, pooled,
                            rng)
        return xt, rotation_output(act, self.rot_pred_type,
                                   self.euler_bins), act[..., -1]


def _masked_softmax(x, mask):
    return torch.softmax(torch.where(mask, x, torch.full_like(x, -1e9)),
                         dim=-1)


def rotation_output(act, rot_pred_type, euler_bins):
    """The rotation slice of an action MLP's output (..., out)."""
    if rot_pred_type == "euler_disc":
        # view(-1, euler_bins, 3): row-major (bin, axis) layout
        return act[..., :euler_bins * 3].reshape(act.shape[:-1] +
                                                 (euler_bins, 3))
    xr = act[..., :ROT_DIMS.get(rot_pred_type, 3)]
    if rot_pred_type == "quat":
        xr = xr / torch.sqrt((xr * xr).sum(-1, keepdim=True).clamp(
            min=1e-12))
    return xr
