"""3D-LOTUS action head, eval path (port of
robot3dlotus_tpu/models/heads.py `ActionHead`): heatmap_disc position,
euler_disc rotation, openness logit, with a masked max over points.

The release configuration uses exactly these; the other position and
rotation types of the JAX head are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import dense


class ActionHead(nn.Module):
    def __init__(self, generator, reduce="max", pos_pred_type="heatmap_disc",
                 rot_pred_type="euler_disc", hidden_size=128,
                 euler_resolution=5, pos_bins=50):
        super().__init__()
        if (reduce, pos_pred_type, rot_pred_type) != \
                ("max", "heatmap_disc", "euler_disc"):
            raise NotImplementedError(
                f"ActionHead({reduce}, {pos_pred_type}, {rot_pred_type}): "
                "the port serves reduce=max, heatmap_disc, euler_disc")
        self.pos_bins = pos_bins
        self.euler_bins = 360 // euler_resolution
        g = generator
        self.heatmap_mlp_fc1 = dense(hidden_size, hidden_size, g)
        self.heatmap_mlp_fc2 = dense(hidden_size, 3 * pos_bins * 2, g)
        self.action_mlp_fc1 = dense(hidden_size, hidden_size, g)
        self.action_mlp_fc2 = dense(hidden_size, self.euler_bins * 3 + 1, g)

    @staticmethod
    def _mlp(fc1, fc2, x):
        return fc2(F.leaky_relu(fc1(x), negative_slope=0.02))

    def forward(self, point_embeds, mask):
        """point_embeds (B, N, D); mask (B, N). Returns
        xt (B, 3, N, 2*pos_bins) logits, xr (B, euler_bins, 3) logits,
        xo (B,) openness logit."""
        B, N, _ = point_embeds.shape
        ht = self._mlp(self.heatmap_mlp_fc1, self.heatmap_mlp_fc2,
                       point_embeds)
        # 'n (c b) -> c n b', then mask padded points out of the softmax
        xt = ht.reshape(B, N, 3, 2 * self.pos_bins).permute(0, 2, 1, 3)
        xt = torch.where(mask[:, None, :, None], xt,
                         torch.full_like(xt, -1e9))
        pooled = torch.where(mask[..., None], point_embeds,
                             torch.full_like(point_embeds, -float("inf"))
                             ).amax(dim=1)
        act = self._mlp(self.action_mlp_fc1, self.action_mlp_fc2, pooled)
        xr = act[..., :self.euler_bins * 3].reshape(B, self.euler_bins, 3)
        return xt, xr, act[..., -1]
