"""Host voxel-grid downsampling with trace and workspace filtering (numpy
copy of robot3dlotus_tpu/ops/voxel.py voxelize_pcd_np / workspace_mask_np).

Output point = mean of the member points of each occupied voxel; attributes
(rgb) come from the first traced member. Voxels are ordered by their
(x, y, z) grid key.
"""
from __future__ import annotations

import numpy as np


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
