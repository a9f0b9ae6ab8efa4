"""Voxel-grid downsampling with trace and workspace filtering (the port's
copy of robot3dlotus_tpu/ops/voxel.py).

Output point = mean of the member points of each occupied voxel; attributes
(rgb) come from the first traced member. voxelize_pcd_np (host numpy)
orders voxels by their (x, y, z) grid key; voxelize_fixed (torch, any
device, static shapes) by the z-order code of the grid key, for the fused
on-device serving preprocess.
"""
from __future__ import annotations

import numpy as np
import torch

from .serialization import SENTINEL, z_order_encode


def voxelize_pcd_np(xyz, voxel_size=0.01):
    """xyz: (N, 3). Returns (vox_xyz (M, 3) means, first_idx (M,) int64).

    The (x, y, z) grid rows are folded into one int64 key that sorts in the
    same lexicographic order, so np.unique sorts N integers instead of N
    structured rows; per-voxel sums accumulate in point order (bincount), so
    the output equals the JAX package's row-unique version bit for bit."""
    xyz = np.asarray(xyz)
    if len(xyz) == 0:
        return xyz, np.zeros(0, np.int64)
    origin = xyz.min(0)
    grid = np.floor((xyz - origin) / voxel_size).astype(np.int64)
    ext = grid.max(0) + 1
    key = (grid[:, 0] * ext[1] + grid[:, 1]) * ext[2] + grid[:, 2]
    _, first, inv, counts = np.unique(key, return_index=True,
                                      return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    M = counts.shape[0]
    sums = np.stack([np.bincount(inv, weights=xyz[:, d].astype(np.float64),
                                 minlength=M) for d in range(3)], -1)
    means = (sums / counts[:, None]).astype(xyz.dtype)
    return means, first.astype(np.int64)


def workspace_mask_np(xyz, workspace, rm_table=True):
    m = (
        (xyz[:, 0] > workspace["X_BBOX"][0])
        & (xyz[:, 0] < workspace["X_BBOX"][1])
        & (xyz[:, 1] > workspace["Y_BBOX"][0])
        & (xyz[:, 1] < workspace["Y_BBOX"][1])
        & (xyz[:, 2] > workspace["Z_BBOX"][0])
        & (xyz[:, 2] < workspace["Z_BBOX"][1])
    )
    if rm_table:
        m = m & (xyz[:, 2] > workspace["TABLE_HEIGHT"])
    return m


def voxelize_fixed(xyz, mask, voxel_size, capacity, depth=10):
    """Static-shape voxelization of the points of xyz (n, 3) float32 where
    mask (n,) holds: (means (capacity, 3), vmask (capacity,), first
    (capacity,) int64, overflow ()) for the first `capacity` occupied
    voxels in z-order of their grid key (depth 10 from the kept points'
    minimum). `first` is each voxel's lowest point index (n - 1 past the
    occupied voxels); `overflow` counts what was dropped: occupied voxels
    past capacity (the largest codes, a contiguous corner of the
    workspace) and kept points past the 2^depth-cell extent (masked out,
    not merged into a boundary voxel). The JAX voxelize_fixed_jnp's
    outputs.

    Deterministic on the card: after the stable sort by code each voxel's
    points are contiguous, so the sums are a sorted-segment reduction
    (torch.segment_reduce: one thread adds a segment's points in order, no
    float atomics) and `first` the sorted order at each segment's start.
    Every point that no kept voxel takes is a segment of its own: one
    segment of all of them would be added by one thread (4.56 ms on an
    H100 for a 262,144-point cloud)."""
    n = xyz.shape[0]
    big = torch.full_like(xyz, 1e9)
    origin = torch.where(mask[:, None], xyz, big).amin(0)
    gc_raw = torch.floor((xyz - origin) / torch.full(
        (), voxel_size, dtype=xyz.dtype, device=xyz.device)).to(torch.int32)
    limit = (1 << depth) - 1
    oob = mask & ((gc_raw < 0) | (gc_raw > limit)).any(1)
    mask = mask & ~oob
    codes = torch.where(mask, z_order_encode(gc_raw.clamp(0, limit), depth),
                        torch.full_like(gc_raw[:, 0], SENTINEL))
    order = torch.argsort(codes, stable=True)
    cs = codes[order]
    valid = cs != SENTINEL
    head = valid.clone()
    head[1:] &= cs[1:] != cs[:-1]
    nseg = head.sum()
    seg = torch.cumsum(head, 0) - 1
    pos = torch.arange(n, device=xyz.device)
    seg = torch.where(valid & (seg < capacity), seg, capacity + pos)
    lengths = torch.zeros(capacity + n, dtype=torch.int64,
                          device=xyz.device).scatter_add_(
        0, seg, torch.ones_like(seg))
    sums = torch.segment_reduce(xyz[order], "sum", lengths=lengths, axis=0,
                                unsafe=True)[:capacity]
    cnt = lengths[:capacity]
    means = sums / cnt.clamp(min=1).to(xyz.dtype)[:, None]
    slots = torch.arange(capacity, device=xyz.device)
    vmask = slots < torch.clamp(nseg, max=capacity)
    starts = (torch.cumsum(cnt, 0) - cnt).clamp(max=n - 1)
    first = torch.where(vmask, order[starts], n - 1)
    overflow = torch.clamp(nseg - capacity, min=0) + oob.sum()
    return means, vmask, first, overflow
