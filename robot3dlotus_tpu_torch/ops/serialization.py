"""Space-filling-curve serialization codes (port of
robot3dlotus_tpu/ops/serialization.py).

z-order (Morton) and Hilbert (Skilling transpose) keys of (..., 3) int32
grid coordinates, with the 'trans' variants swapping x and y. Codes are
int32 (depth <= 10) and bit-equal to the JAX package's. Their numpy
twins, in sfc_np.py, serve the host presorts.
"""
from __future__ import annotations

import torch

from .sfc_np import MAX_DEPTH_I32, SENTINEL, SFC_ORDERS


def z_order_encode(grid_coord: torch.Tensor, depth: int = 10) -> torch.Tensor:
    """Morton key. grid_coord: (..., 3) int in [0, 2^depth)."""
    assert depth <= MAX_DEPTH_I32
    key = torch.zeros_like(grid_coord[..., 0], dtype=torch.int32)
    for a in range(3):
        key = key | z_order_axis_interleave(grid_coord[..., a], a, depth)
    return key


def z_order_axis_interleave(v: torch.Tensor, axis: int,
                            depth: int = 10) -> torch.Tensor:
    """One axis' bits in its Morton lanes (x/y/z -> bit 3i+2 / 3i+1 / 3i)."""
    assert depth <= MAX_DEPTH_I32
    v = v.to(torch.int32)
    key = torch.zeros_like(v)
    for i in range(depth):
        key = key | ((v & (1 << i)) << (2 * i + (2 - axis)))
    return key


def hilbert_encode(grid_coord: torch.Tensor, depth: int = 10) -> torch.Tensor:
    """Hilbert key via Skilling's AxesToTranspose, branchless."""
    assert depth <= MAX_DEPTH_I32
    X = [grid_coord[..., d].to(torch.int32) for d in range(3)]
    Q = 1 << (depth - 1)
    while Q > 1:
        P = Q - 1
        for i in range(3):
            cond = (X[i] & Q) > 0
            t = (X[0] ^ X[i]) & P
            x0_if, x0_else, xi_else = X[0] ^ P, X[0] ^ t, X[i] ^ t
            X[0] = torch.where(cond, x0_if, x0_else)
            if i != 0:
                X[i] = torch.where(cond, X[i], xi_else)
        Q >>= 1
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = torch.zeros_like(X[0])
    Q = 1 << (depth - 1)
    while Q > 1:
        t = torch.where((X[2] & Q) > 0, t ^ (Q - 1), t)
        Q >>= 1
    X = [X[0] ^ t, X[1] ^ t, X[2] ^ t]
    key = torch.zeros_like(X[0])
    for b in range(depth):
        src = depth - 1 - b
        for d in range(3):
            dst = 3 * (depth - 1 - b) + (2 - d)
            key = key | (((X[d] >> src) & 1) << dst)
    return key


def sfc_encode(grid_coord: torch.Tensor, order: str,
               depth: int = 10) -> torch.Tensor:
    assert order in SFC_ORDERS, order
    if order.endswith("-trans"):
        grid_coord = grid_coord[..., [1, 0, 2]]
    if order.startswith("z"):
        return z_order_encode(grid_coord, depth)
    return hilbert_encode(grid_coord, depth)


def serialize_codes(grid_coord: torch.Tensor, mask: torch.Tensor, depth: int,
                    orders=SFC_ORDERS) -> torch.Tensor:
    """(B, N, 3) grid coords, (B, N) mask -> (num_orders, B, N) int32 codes;
    invalid points get INT32_MAX so they sort to the tail."""
    codes = torch.stack([sfc_encode(grid_coord, o, depth) for o in orders])
    return torch.where(mask[None], codes,
                       torch.full_like(codes, SENTINEL))


def argsort_with_inverse(codes: torch.Tensor):
    """Stable ascending sort of each (B, N) row -> (order, inverse)."""
    order = torch.argsort(codes, dim=-1, stable=True)
    ranks = torch.arange(codes.shape[-1], device=codes.device)
    inverse = torch.empty_like(order).scatter_(
        -1, order, ranks.expand_as(order).contiguous())
    return order, inverse
