"""Submanifold sparse conv: stencil neighbour maps and the conv apply (port
of robot3dlotus_tpu/ops/sparse_conv.py).

A submanifold conv keeps the active-site set fixed: for each active voxel
v, out[v] = sum_o W[o]^T feat[neighbour(v, o)] over the k^3 stencil
offsets o, skipping empty neighbours. build_neighbor_map finds the
neighbours once per stage as a (B, N, K) index map plus an `ok` mask,
bit-equal to the JAX package's (lowest index wins on duplicate
coordinates). subm_conv_apply dispatches to the hand-written kernels: the
k=5 stem (Cin <= 8, no bias) to K3 (ops/stem.py), every other stencil to K2
(ops/conv.py), and a stem with a categorical channel (the motion planner's
point labels) to K9 followed by the label reconstruct and one matrix
product (categorical_conv). Under compute_dtype bfloat16 feat and the
weight arrive in bf16 (the SubMConv module casts them; the bias stays
fp32) and every path sums in fp32 and rounds once, as the JAX XLA conv
does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .conv import subm_conv
from .gather import SMALLC_MAX, gather_rows_smallc
from .serialization import SENTINEL, z_order_axis_interleave, z_order_encode
from .stem import MAX_CIN, stem_conv


class NeighborMap(NamedTuple):
    idx: torch.Tensor   # (B, N, K) int32 — frame index of the neighbour
    ok: torch.Tensor    # (B, N, K) bool — neighbour exists


def stencil_offsets(kernel_size: int) -> np.ndarray:
    """k^3 offsets in spconv's iteration order (x-major, ascending)."""
    r = kernel_size // 2
    rng = np.arange(-r, kernel_size - r)
    grid = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3).astype(np.int32)  # (K, 3)


def build_neighbor_map(grid_coord, mask, kernel_size: int, depth: int,
                       extent: int | None = None) -> NeighborMap:
    """grid_coord: (B, N, 3) int32 >= 0; mask: (B, N) bool.

    extent > 0: look neighbours up in a dense (B, extent^3) occupancy
    table, unless a valid coordinate is out of extent, in which case the
    whole batch takes the extent-free z-order searchsorted path (both give
    the same map). The out-of-extent test reads one scalar back to the
    host."""
    if extent is not None and extent > 0:
        oob = bool(((grid_coord.amax(-1) >= extent) & mask).any())
        if not oob:
            return _build_neighbor_map_dense(grid_coord, mask, kernel_size,
                                             extent)
    return _build_neighbor_map_sorted(grid_coord, mask, kernel_size, depth)


def _build_neighbor_map_sorted(grid_coord, mask, kernel_size: int,
                               depth: int) -> NeighborMap:
    B, N, _ = grid_coord.shape
    offs = stencil_offsets(kernel_size)
    K = offs.shape[0]
    codes = torch.where(mask, z_order_encode(grid_coord, depth),
                        torch.full_like(mask, SENTINEL, dtype=torch.int32))
    sort_idx = torch.argsort(codes, dim=-1, stable=True)
    codes_sorted = torch.gather(codes, -1, sort_idx)

    # stencil query keys: z-order lanes are disjoint per axis, so
    # code(p + off) is the OR of three shifted-axis interleaves
    r = kernel_size // 2
    hi = (1 << depth) - 1
    ax_key, ax_ok = [], []
    for a in range(3):
        va = grid_coord[..., a]
        ax_key.append({d: z_order_axis_interleave(
            torch.clamp(va + d, 0, hi), a, depth)
            for d in range(-r, kernel_size - r)})
        ax_ok.append({d: (va + d >= 0) & (va + d <= hi)
                      for d in range(-r, kernel_size - r)})
    q_codes = torch.stack([ax_key[0][dx] | ax_key[1][dy] | ax_key[2][dz]
                           for dx, dy, dz in offs.tolist()], dim=-1)
    in_range = torch.stack([ax_ok[0][dx] & ax_ok[1][dy] & ax_ok[2][dz]
                            for dx, dy, dz in offs.tolist()], dim=-1)

    q = q_codes.reshape(B, N * K)
    pos = torch.searchsorted(codes_sorted, q).clamp(0, N - 1)
    found = torch.gather(codes_sorted, -1, pos) == q
    nbr = torch.gather(sort_idx, -1, pos).to(torch.int32)
    ok = found.reshape(B, N, K) & in_range & mask[:, :, None]
    idx = torch.where(ok, nbr.reshape(B, N, K), torch.zeros_like(nbr).reshape(
        B, N, K))
    return NeighborMap(idx=idx, ok=ok)


def _build_neighbor_map_dense(grid_coord, mask, kernel_size: int,
                              extent: int) -> NeighborMap:
    B, N, _ = grid_coord.shape
    dev = grid_coord.device
    offs = torch.as_tensor(stencil_offsets(kernel_size), device=dev)
    K = offs.shape[0]
    E = extent
    cells = E * E * E
    gc = grid_coord.to(torch.int64)

    in_ext = ((gc >= 0) & (gc < E)).all(-1) & mask
    lin = gc[..., 0] * (E * E) + gc[..., 1] * E + gc[..., 2]
    lin_own = torch.where(in_ext, lin, torch.full_like(lin, cells))
    # min: the lowest frame index wins for duplicate coordinates
    table = torch.full((B, cells + 1), N, dtype=torch.int64, device=dev)
    table.scatter_reduce_(1, lin_own, torch.arange(N, device=dev).expand(
        B, N), reduce="amin", include_self=True)

    q = gc[:, :, None, :] + offs[None, None]                 # (B, N, K, 3)
    q_ok = ((q >= 0) & (q < E)).all(-1)
    lin_q = q[..., 0] * (E * E) + q[..., 1] * E + q[..., 2]
    lin_q = torch.where(q_ok, lin_q, torch.full_like(lin_q, cells))
    nbr = torch.gather(table, 1, lin_q.reshape(B, N * K)).reshape(B, N, K)
    ok = (nbr < N) & q_ok & mask[:, :, None]
    idx = torch.where(ok, nbr, torch.zeros_like(nbr)).to(torch.int32)
    return NeighborMap(idx=idx, ok=ok)


def categorical_conv(feat, nmap: NeighborMap, weight, categorical):
    """The conv of feat with the embedded channels cat_table[cat_idx]
    appended, without gathering the E embedding channels (sparse_conv.py:
    209-299 of the JAX package): the raw index rides K9 as one more channel,
    ONE-BASED, and every missing link points at the sentinel row N, which K9
    turns into a zero row; a zero index channel matches no table entry, so it
    reconstructs to a zero embedding. Then the one-hot x table reconstruct,
    the ok mask and one (B*N, K*(Cin+E)) x (K*(Cin+E), Cout) product. The
    table's and the weight's gradients come from autograd of the
    reconstruct and the product.

    With bf16 feat (compute_dtype bfloat16) the rows, the index channel
    and the table go to bf16 (K9 gathers 2-byte rows; the one-hot picks
    exact table rows, as the JAX `materialize_categorical` casts
    cat_table[idx] to feat's dtype), the product sums in fp32 and the
    caller's bias is added before the one rounding. A bf16 index channel
    holds integers exactly only up to 256, so a larger table raises."""
    cat_idx, cat_table = categorical
    B, N, C = feat.shape
    K = nmap.idx.shape[-1]
    if feat.dtype == torch.bfloat16 and cat_table.shape[0] + 1 > 256:
        raise ValueError(f"categorical conv: {cat_table.shape[0]} labels do "
                         f"not fit a bf16 index channel (at most 255)")
    rows = torch.cat([feat, (cat_idx + 1).to(feat.dtype)[..., None]], -1)
    idx = torch.where(nmap.ok, nmap.idx, torch.full_like(nmap.idx, N))
    g = gather_rows_smallc(rows, idx.reshape(B, N * K)).reshape(
        B, N, K, C + 1)
    ids = torch.arange(1, cat_table.shape[0] + 1, device=feat.device)
    onehot = (g[..., -1:].long() == ids).to(feat.dtype)
    g = torch.cat([g[..., :-1], onehot @ cat_table.to(feat.dtype)], -1)
    g = torch.where(nmap.ok[..., None], g, g.new_zeros(()))
    cw = g.shape[-1]
    out = g.reshape(B * N, K * cw).float() @ weight.reshape(K * cw,
                                                            -1).float()
    return out.reshape(B, N, -1)


def subm_conv_apply(feat, nmap: NeighborMap, weight, bias=None,
                    categorical=None):
    """feat (B, N, Cin); weight (K, Cin + E, Cout); bias (Cout,) or None;
    categorical: None, or (idx (B, N) int in [0, Kcat), table (Kcat, E)),
    embedded channels logically appended to feat.

    out[b, n] = sum_k ok * W[k]^T feat[b, idx[b, n, k]] (+ bias)"""
    if categorical is not None:
        if feat.shape[-1] + 1 > SMALLC_MAX:
            raise ValueError(f"categorical conv: {feat.shape[-1]} + 1 "
                             f"channels > {SMALLC_MAX}")
        out = categorical_conv(feat, nmap, weight, categorical)
        return (out if bias is None else out + bias).to(feat.dtype)
    if bias is None and feat.shape[-1] <= MAX_CIN:
        return stem_conv(feat, nmap.idx, nmap.ok, weight)
    return subm_conv(feat, nmap.idx, nmap.ok, weight, bias)
