"""Space-filling-curve codes in numpy (the host twins of
ops/serialization.py): z-order (Morton) and Hilbert keys of (..., 3) int32
grid coordinates, the 'trans' variants swapping x and y; int32 codes
(depth <= 10) bit-equal to the torch versions and to the JAX package's.
They serve the host presorts (the eval actioner's, the training batches'
under TRAIN.host_structure). This module imports no torch: the loader's
worker processes use it.
"""
from __future__ import annotations

import numpy as np

SFC_ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")

MAX_DEPTH_I32 = 10  # 3*10 = 30 bits < 31
SENTINEL = int(np.iinfo(np.int32).max)


def z_order_encode_np(grid_coord, depth: int = 10):
    assert depth <= MAX_DEPTH_I32
    x, y, z = (grid_coord[..., d].astype(np.int32) for d in range(3))
    key = np.zeros_like(x)
    for i in range(depth):
        m = np.int32(1 << i)
        key = (key | ((x & m) << (2 * i + 2)) | ((y & m) << (2 * i + 1))
               | ((z & m) << (2 * i + 0)))
    return key


def hilbert_encode_np(grid_coord, depth: int = 10):
    assert depth <= MAX_DEPTH_I32
    X = [grid_coord[..., d].astype(np.int32) for d in range(3)]
    Q = 1 << (depth - 1)
    while Q > 1:
        P = np.int32(Q - 1)
        for i in range(3):
            cond = (X[i] & Q) > 0
            t = (X[0] ^ X[i]) & P
            x0_if, x0_else, xi_else = X[0] ^ P, X[0] ^ t, X[i] ^ t
            X[0] = np.where(cond, x0_if, x0_else)
            if i != 0:
                X[i] = np.where(cond, X[i], xi_else)
        Q >>= 1
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = np.zeros_like(X[0])
    Q = 1 << (depth - 1)
    while Q > 1:
        t = np.where((X[2] & Q) > 0, t ^ np.int32(Q - 1), t)
        Q >>= 1
    X = [X[0] ^ t, X[1] ^ t, X[2] ^ t]
    key = np.zeros_like(X[0])
    for b in range(depth):
        src = depth - 1 - b
        for d in range(3):
            dst = 3 * (depth - 1 - b) + (2 - d)
            key = key | (((X[d] >> src) & 1) << dst)
    return key


def sfc_encode_np(grid_coord, order: str, depth: int = 10):
    assert order in SFC_ORDERS, order
    if order.endswith("-trans"):
        grid_coord = grid_coord[..., [1, 0, 2]]
    if order.startswith("z"):
        return z_order_encode_np(grid_coord, depth)
    return hilbert_encode_np(grid_coord, depth)
