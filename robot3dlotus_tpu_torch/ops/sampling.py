"""Farthest-point sampling (the port's copy of
robot3dlotus_tpu/ops/sampling.py).

`farthest_point_sample_np` is the greedy host version (a random first pick
unless `start` is given). `farthest_point_sample` is the counterpart of the
JAX version's lax.scan: a loop of npoint steps on the tensors' device, each
one distance update and one masked argmax, the first pick `start` and ties
to the lowest index, as jnp.argmax breaks them. The picked index stays on
the device, so the loop reads nothing back.
"""
from __future__ import annotations

import numpy as np
import torch


def farthest_point_sample_np(points: np.ndarray, npoint: int,
                             start: int | None = None,
                             rng: np.random.RandomState | None = None):
    """Greedy FPS on the host; returns the sampled rows of `points`."""
    n = len(points)
    xyz = points[:, :3]
    if start is None:
        start = int((rng or np.random).randint(0, n))
    idxs = np.zeros(npoint, np.int32)
    distance = np.full(n, 1e10, points.dtype)
    farthest = start
    for i in range(npoint):
        idxs[i] = farthest
        d = np.sum((xyz - xyz[farthest]) ** 2, -1)
        np.minimum(distance, d, out=distance)
        farthest = int(np.argmax(distance))
    return points[idxs]


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          mask: torch.Tensor | None = None,
                          start: int = 0) -> torch.Tensor:
    """FPS indices on xyz's device. xyz: (N, 3); mask: (N,) bool validity
    (masked-out rows are never picked). Returns (npoint,) int32."""
    n = xyz.shape[0]
    big = torch.tensor(1e10, dtype=xyz.dtype, device=xyz.device)
    distance = torch.full((n,), 1e10, dtype=xyz.dtype, device=xyz.device)
    if mask is not None:
        distance = torch.where(mask, distance, -big)
    farthest = torch.tensor([start], dtype=torch.long, device=xyz.device)
    idxs = torch.empty(npoint, dtype=torch.long, device=xyz.device)
    for i in range(npoint):
        idxs[i:i + 1] = farthest
        d = ((xyz - xyz.index_select(0, farthest)) ** 2).sum(-1)
        distance = torch.minimum(distance, d)
        score = distance if mask is None else torch.where(mask, distance,
                                                          -big)
        farthest = score.argmax().view(1)
    return idxs.int()
