"""Discretized per-axis position codec (port of
robot3dlotus_tpu/ops/pos_codec.py).

For every point and axis c the head predicts logits over 2*pos_bins
candidate offsets: candidate = point_xyz[c] + (k - pos_bins) * pos_bin_size.
The training target spreads probability over the candidates within
support_radius of the ground truth ('plain' uniformly, 'dist' by inverse
distance), zeroes robot points and falls back to the nearest candidate
when an axis has no support. The decode softmaxes over all candidates of
an axis and picks the best one ('max', the release setting; the 'ens1'
vote of the JAX package waits for the eval servers).
"""
from __future__ import annotations

import numpy as np
import torch


def disc_pos_gt_prob_np(xyz, gt_pos, pos_bin_size=0.01, pos_bins=50,
                        heatmap_type="plain", robot_point_idxs=None,
                        support_radius=0.01):
    """One unpadded cloud on the host: xyz (n, 3), gt_pos (3,) ->
    (3, n * 2 * pos_bins) float32, rows summing to 1."""
    npoints = xyz.shape[0]
    shift = np.arange(-pos_bins, pos_bins, dtype=np.float32) * pos_bin_size
    cands = xyz[:, :, None].astype(np.float32) + shift[None, None, :]
    dists = np.abs(np.asarray(gt_pos, np.float32)[None, :, None] - cands)
    if heatmap_type == "plain":
        prob = (dists < support_radius).astype(np.float32)
    else:  # 'dist'
        prob = 1.0 / np.maximum(dists, 1e-4)
        prob[dists > support_radius] = 0.0
    if robot_point_idxs is not None and len(robot_point_idxs) > 0:
        prob[np.asarray(robot_point_idxs)] = 0.0
    prob = np.transpose(prob, (1, 0, 2)).reshape(3, npoints * pos_bins * 2)
    flat_dists = np.transpose(dists, (1, 0, 2)).reshape(3, -1)
    for c in range(3):
        if prob[c].sum() == 0:
            prob[c, np.argmin(flat_dists[c])] = 1.0
    prob = prob / prob.sum(-1, keepdims=True)
    return prob.astype(np.float32)


def disc_pos_gt_prob(xyz, valid_mask, gt_pos, robot_mask=None,
                     pos_bin_size=0.01, pos_bins=50, heatmap_type="dist",
                     support_radius=0.01):
    """Padded clouds on the device: xyz (B, N, 3), valid_mask (B, N),
    gt_pos (B, 3), robot_mask (B, N) (True = zeroed) or None ->
    (B, 3, N * 2 * pos_bins) float32 rows summing to 1 (the JAX package's
    disc_pos_gt_prob_jnp over a batch). Padded points get no probability
    and are never the nearest-candidate fallback."""
    B, N, _ = xyz.shape
    nb = 2 * pos_bins
    shift = (torch.arange(nb, dtype=torch.float32, device=xyz.device)
             - pos_bins) * pos_bin_size
    cands = xyz.float()[..., None] + shift                  # (B, N, 3, nb)
    dists = (gt_pos.float()[:, None, :, None] - cands).abs()
    if heatmap_type == "plain":
        prob = (dists < support_radius).float()
    else:  # 'dist'
        prob = torch.where(dists > support_radius, torch.zeros_like(dists),
                           1.0 / dists.clamp(min=1e-4))
    keep = valid_mask if robot_mask is None else valid_mask & ~robot_mask
    prob = torch.where(keep[..., None, None], prob, torch.zeros_like(prob))
    prob = prob.permute(0, 2, 1, 3).reshape(B, 3, N * nb)
    flat = dists.permute(0, 2, 1, 3).reshape(B, 3, N * nb)
    cand_valid = valid_mask.repeat_interleave(nb, dim=1)[:, None, :]
    flat = torch.where(cand_valid, flat, torch.full_like(flat, float("inf")))
    fallback = torch.zeros_like(prob).scatter_(
        -1, flat.argmin(-1, keepdim=True), 1.0)
    prob = torch.where(prob.sum(-1, keepdim=True) > 0, prob, fallback)
    return prob / prob.sum(-1, keepdim=True)


def best_pos_from_disc_logits(logits, xyz, mask=None, pos_bin_size=0.01,
                              pos_bins=50, best="max"):
    """logits (B, 3, N, 2*pos_bins); xyz (B, N, 3); mask (B, N) or None.
    Returns (B, 3) float32."""
    if best != "max":
        raise NotImplementedError(f"best_disc_pos={best!r}")
    B, _, N, nbins = logits.shape
    shift = (torch.arange(nbins, dtype=torch.float32, device=logits.device)
             - pos_bins) * pos_bin_size
    cands = xyz.transpose(1, 2)[..., None] + shift            # (B, 3, N, nb)
    flat = logits.reshape(B, 3, N * nbins)
    if mask is not None:
        m = mask.repeat_interleave(nbins, dim=1)[:, None, :]
        flat = torch.where(m, flat, torch.full_like(flat, -1e9))
    prob = torch.softmax(flat, dim=-1)
    idx = torch.argmax(prob, dim=-1, keepdim=True)
    return torch.gather(cands.reshape(B, 3, N * nbins), -1, idx)[..., 0]
