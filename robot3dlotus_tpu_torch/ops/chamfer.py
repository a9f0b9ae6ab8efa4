"""Chamfer and nearest-pair distances between small point clouds (the
port's copy of robot3dlotus_tpu/ops/chamfer.py).

The grounding pipeline's clouds hold a few thousand points, so the
pairwise squared distances |a|^2 + |b|^2 - 2 a.b are one matrix product.
The numpy versions run in float64 on the host: the VLM pipeline and the
robot pipeline decide object merges and target matches with them, and
float64 keeps those decisions equal to the JAX package's. `chamfer_distance`
is the torch counterpart of `chamfer_distance_jnp`, on the device its
tensors live on.
"""
from __future__ import annotations

import numpy as np


def _pairwise_sqdist_np(a, b):
    a2 = np.sum(a * a, -1)[:, None]
    b2 = np.sum(b * b, -1)[None, :]
    return np.maximum(a2 + b2 - 2.0 * (a @ b.T), 0.0)


def chamfer_distance_np(src, tgt, point_reduction="mean"):
    """One-directional chamfer: each src point's nearest squared distance
    to tgt, reduced by `point_reduction` (mean, sum or min); inf when a
    cloud is empty."""
    if len(src) == 0 or len(tgt) == 0:
        return np.inf
    d = _pairwise_sqdist_np(np.asarray(src, np.float64),
                            np.asarray(tgt, np.float64)).min(-1)
    if point_reduction == "mean":
        return float(d.mean())
    if point_reduction == "sum":
        return float(d.sum())
    if point_reduction == "min":
        return float(d.min())
    raise ValueError(point_reduction)


def min_pair_distance_np(a, b):
    """The least Euclidean distance over all pairs (the 'min'-reduced
    chamfer the merging heuristics use)."""
    return float(np.sqrt(chamfer_distance_np(a, b, "min")))


def _pairwise_sqdist(a, b):
    a2 = (a * a).sum(-1)[:, None]
    b2 = (b * b).sum(-1)[None, :]
    return (a2 + b2 - 2.0 * (a @ b.T)).clamp(min=0.0)


def chamfer_distance(src, tgt, point_reduction="mean"):
    """chamfer_distance_np on tensors (fp32, on their device): a 0-d
    tensor."""
    d = _pairwise_sqdist(src.float(), tgt.float()).min(-1).values
    if point_reduction == "mean":
        return d.mean()
    if point_reduction == "sum":
        return d.sum()
    if point_reduction == "min":
        return d.min()
    raise ValueError(point_reduction)
