"""Discretized per-axis position decode (port of
robot3dlotus_tpu/ops/pos_codec.py `best_pos_from_disc_logits`).

For every point and axis c the head predicts logits over 2*pos_bins
candidate offsets: candidate = point_xyz[c] + (k - pos_bins) * pos_bin_size.
The decode softmaxes over all candidates of an axis and picks the best one
('max', the release setting; the 'ens1' vote of the JAX package waits for
the eval servers).
"""
from __future__ import annotations

import torch


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
