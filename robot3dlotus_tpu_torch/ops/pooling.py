"""Serialized grid pooling / unpooling as masked segment reductions (port of
robot3dlotus_tpu/ops/pooling.py).

Points arrive sorted by their first-order SFC code; a cluster (parent voxel)
is a run of equal code >> 3, segment ids are a cumsum of run heads, and the
reductions scatter into a fixed child capacity. Segments beyond the
capacity are dropped (their slot is child_cap), as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .gather import gather_rows


class PoolMaps(NamedTuple):
    seg_sorted: torch.Tensor       # (B, N) int64: segment of each slot (child_cap = drop)
    head_sorted_pos: torch.Tensor  # (B, C) int64: sorted position of each head
    child_mask: torch.Tensor       # (B, C) bool
    child_counts: torch.Tensor     # (B,) int64: number of segments


def build_pool_maps(codes0_sorted, valid_counts, child_cap):
    """codes0_sorted: (B, N) int32 ascending (sentinel tail), the frame of
    the points (sorted-resident: a segment id is also each point's
    cluster). One stride-2 level: parent = code >> 3."""
    B, N = codes0_sorted.shape
    dev = codes0_sorted.device
    parent = codes0_sorted >> 3
    p = torch.arange(N, device=dev)[None, :]
    valid = p < valid_counts[:, None]
    prev = torch.cat([torch.full((B, 1), -1, dtype=parent.dtype, device=dev),
                      parent[:, :-1]], dim=1)
    head = (parent != prev) & valid
    seg = torch.cumsum(head.long(), dim=1) - 1
    child_counts = head.long().sum(1)
    seg = torch.where(valid & (seg < child_cap), seg,
                      torch.full_like(seg, child_cap))

    head_pos = torch.full((B, child_cap + 1), N, dtype=torch.int64,
                          device=dev)
    head_pos.scatter_reduce_(1, seg, p.expand(B, N), reduce="amin",
                             include_self=True)
    head_pos = head_pos[:, :child_cap].clamp(0, N - 1)

    cidx = torch.arange(child_cap, device=dev)[None, :]
    child_mask = cidx < torch.clamp(child_counts, max=child_cap)[:, None]
    return PoolMaps(seg, head_pos, child_mask, child_counts)


def segment_reduce(values_sorted, maps: PoolMaps, child_cap, reduce="max"):
    """values_sorted (B, N, C) in sorted order -> (B, child_cap, C) per
    segment max or mean (dropped slots and empty children are 0)."""
    B, N, C = values_sorted.shape
    seg = maps.seg_sorted[..., None].expand(B, N, C)
    if reduce == "max":
        out = values_sorted.new_full((B, child_cap + 1, C), float("-inf"))
        out.scatter_reduce_(1, seg, values_sorted, reduce="amax",
                            include_self=True)
    elif reduce == "mean":
        out = values_sorted.new_zeros((B, child_cap + 1, C))
        out.scatter_add_(1, seg, values_sorted)
        cnt = values_sorted.new_zeros((B, child_cap + 1, 1))
        cnt.scatter_add_(1, maps.seg_sorted[..., None],
                         values_sorted.new_ones((B, N, 1)))
        out = out / torch.clamp(cnt, min=1.0)
    else:
        raise ValueError(reduce)
    out = out[:, :child_cap]
    return torch.where(maps.child_mask[..., None], out,
                       torch.zeros_like(out))


def take_rows(x, rows):
    """x (B, N, ...), rows (B, M) int64 -> (B, M, ...) = x[b, rows[b, m]]."""
    idx = rows
    while idx.dim() < x.dim():
        idx = idx[..., None]
    return torch.gather(x, 1, idx.expand(rows.shape + x.shape[2:]))


def gather_heads(x, maps: PoolMaps):
    """x (B, N, ...) in the sorted frame -> (B, child_cap, ...) attribute
    of each segment's head."""
    return take_rows(x, maps.head_sorted_pos)


def unpool_gather(child_feat, cluster, child_cap):
    """child_feat (B, child_cap, D); cluster (B, N) segment per parent
    point, with child_cap = dropped -> a zero row. Returns (B, N, D)
    through K4, whose sentinel contract gives the zero row (the JAX package
    appends a zero row at child_cap and gathers from that copy)."""
    return gather_rows(child_feat, cluster)
