"""Dense patch construction for serialized attention (port of
robot3dlotus_tpu/ops/patching.py).

Each cloud's serialized sequence is padded up to a multiple of the patch
size P by duplicating points of the previous patch. For sorted position p
of a cloud with m points:
    src(p) = p                 if p <  m          (real point)
    src(p) = p - P             if m <= p < npad   (duplicate of prev patch)
    src(p) = 0  (masked)       if p >= npad       (dead slot)
with npad = ceil(m/P)*P when m > P else m. Dead slots are the only masked
keys.
"""
from __future__ import annotations

import torch

from .gather import gather_rows


def build_pad_maps(valid_counts: torch.Tensor, capacity: int,
                   patch_size: int):
    """(B,) counts -> src_pos (B, N) int32, key_valid (B, N) bool."""
    assert capacity % patch_size == 0
    m = valid_counts[:, None].to(torch.int32)
    p = torch.arange(capacity, dtype=torch.int32,
                     device=valid_counts.device)[None, :]
    npad = torch.where(m > patch_size,
                       ((m + patch_size - 1) // patch_size) * patch_size, m)
    src_pos = torch.where(p < m, p, torch.where(p < npad, p - patch_size,
                                                torch.zeros_like(p)))
    return src_pos, p < npad


def dup_pad_identity(x_sorted: torch.Tensor, counts: torch.Tensor,
                     patch_size: int):
    """Duplicate-padding of a cloud already in serialized order: a shift by
    P and a select. Live rows (p < npad) match gather_sorted with the
    identity order; dead rows hold shifted values that every consumer
    masks."""
    N = x_sorted.shape[1]
    p = torch.arange(N, device=x_sorted.device)[None, :]
    sel = p < counts[:, None]
    shifted = torch.cat([torch.zeros_like(x_sorted[:, :patch_size]),
                         x_sorted], dim=1)[:, :N]
    while sel.dim() < x_sorted.dim():
        sel = sel[..., None]
    return torch.where(sel, x_sorted, shifted)


def gather_sorted(x: torch.Tensor, order: torch.Tensor,
                  src_pos: torch.Tensor):
    """out[b, p] = x[b, order[b, src_pos[b, p]]] (x in original order)."""
    return gather_rows(x, torch.gather(order, -1, src_pos.long()))


def scatter_back(attn_out: torch.Tensor, inverse: torch.Tensor):
    """Per-original-point rows of a padded-serialized array: the rank of
    every valid point indexes a real (non-duplicate) slot."""
    return gather_rows(attn_out, inverse)
