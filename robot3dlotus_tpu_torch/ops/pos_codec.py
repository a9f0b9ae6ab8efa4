"""Discretized per-axis position codec (port of
robot3dlotus_tpu/ops/pos_codec.py).

For every point and axis c the head predicts logits over 2*pos_bins
candidate offsets: candidate = point_xyz[c] + (k - pos_bins) * pos_bin_size.
The training target spreads probability over the candidates within
support_radius of the ground truth ('plain' uniformly, 'dist' by inverse
distance), zeroes robot points and falls back to the nearest candidate
when an axis has no support. The decode softmaxes over all candidates of
an axis and picks the best one: 'max' (the release setting) takes the
most probable candidate, 'ens1' the centre of the 5 mm voxel whose
candidates hold the most probability.
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
    and are never the nearest-candidate fallback. gt_pos (B, L, 3), one
    position per trajectory step of the motion planner, gives
    (B, L, 3, N * 2 * pos_bins)."""
    if gt_pos.dim() == 3:
        B, L, _ = gt_pos.shape

        def rep(t):
            return None if t is None else t.repeat_interleave(L, dim=0)
        out = disc_pos_gt_prob(rep(xyz), rep(valid_mask),
                               gt_pos.reshape(B * L, 3), rep(robot_mask),
                               pos_bin_size, pos_bins, heatmap_type,
                               support_radius)
        return out.reshape(B, L, 3, -1)
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
                              pos_bins=50, best="max", vote_voxel_size=0.005,
                              vote_range=512):
    """logits (B, 3, N, 2*pos_bins); xyz (B, N, 3); mask (B, N) or None.
    Returns (B, 3) float32."""
    if best not in ("max", "ens1"):
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
    cands = cands.reshape(B, 3, N * nbins)
    if best == "ens1":
        return _vote(cands, prob, vote_voxel_size, vote_range)
    idx = torch.argmax(prob, dim=-1, keepdim=True)
    return torch.gather(cands, -1, idx)[..., 0]


def _vote(cands, prob, voxel_size, vote_range):
    """The 'ens1' decode: each axis' probability summed over the candidates
    of each of 2 vote_range voxels (rounded, clipped), the best voxel's
    centre. The sums are segment sums over the candidates sorted by voxel
    (a stable sort: each voxel sums its candidates in index order), with
    no float atomics, so a near tie resolves the same way on every run."""
    B, A, M = cands.shape
    V = 2 * vote_range
    # a device divisor: CUDA's division by a Python scalar multiplies by its
    # reciprocal, which moves candidates across voxel edges
    vox = torch.round(cands / torch.full((), voxel_size, dtype=cands.dtype,
                                         device=cands.device))
    vox = (vox.to(torch.int64) + vote_range).clamp(0, V - 1)
    key = (vox + V * torch.arange(B * A, device=vox.device).reshape(
        B, A, 1)).reshape(-1)
    order = torch.sort(key, stable=True).indices
    sums = torch.segment_reduce(prob.reshape(-1)[order], "sum",
                                lengths=torch.bincount(key,
                                                       minlength=B * A * V))
    best = sums.reshape(B, A, V).argmax(-1)
    return (best.to(torch.float32) - vote_range) * voxel_size
