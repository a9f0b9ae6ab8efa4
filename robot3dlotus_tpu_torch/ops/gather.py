"""K4, batched row gather, and K8, its backward (port of
robot3dlotus_tpu/ops/pallas_gather.py `permute_rows` and the custom VJP
`_permute_op`): out[b, m] = x[b, idx[b, m]], and the cotangent
dx[b, idx[b, m]] += g[b, m]. K9 and K10 are the same pair for rows of at
most 32 channels with sentinel rows (`gather_rows_smallc` and its custom
VJP `_smallc_op`): an index outside [0, N) gathers a zero row, and its
cotangent is dropped.

gather_rows serves patching.gather_sorted / scatter_back, the decoder's
unpool_gather (ops/pooling.py) and the pooled stages' entry sorts
(models/ptv3.py); gather_rows_smallc serves the motion planner's
categorical stem (ops/sparse_conv.py, idx == N where a neighbour is
missing) and, through permute_rows_any, the stage-0 entry sort of the
input features. Both are differentiable, with K8 and K10 as their
backwards. The CUDA kernels are in csrc/gather.cu and
csrc/gather_smallc.cu; the *_plain functions are the same functions in
PyTorch, the path for CPU tensors and the oracles the kernels are held
against.
"""
from __future__ import annotations

import torch

from . import cuda_lib


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D), idx (B, M) int in [0, N) -> (B, M, D)."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[-1]))


def scatter_rows_add_plain(g: torch.Tensor, idx: torch.Tensor,
                           n: int) -> torch.Tensor:
    """g (B, M, D), idx (B, M) int in [0, n) -> (B, n, D) fp32 with
    out[b, idx[b, m]] += g[b, m] (colliding indices sum)."""
    B, M, D = g.shape
    out = torch.zeros((B, n, D), dtype=torch.float32, device=g.device)
    return out.scatter_add_(1, idx.long()[..., None].expand(B, M, D),
                            g.float())


def _check_rows(name, x, idx):
    cuda_lib.check_cuda_tensor(f"{name} x", x, torch.float32, 3)
    cuda_lib.check_cuda_tensor(f"{name} idx", idx, torch.int32, 2)
    if idx.shape[0] != x.shape[0]:
        raise ValueError(f"{name}: batch {idx.shape[0]} != {x.shape[0]}")


def _gather_kernel(x, idx):
    _check_rows("gather_rows", x, idx)
    B, N, D = x.shape
    M = idx.shape[1]
    out = torch.empty((B, M, D), dtype=x.dtype, device=x.device)
    cuda_lib.launch("gather_rows", "r3dl_gather_rows", x.data_ptr(),
                    idx.data_ptr(), out.data_ptr(), B, N, M, D)
    return out


def scatter_rows_add(g: torch.Tensor, idx: torch.Tensor, n: int):
    """Row scatter-add: the CUDA kernel (fp32 atomicAdd, so colliding rows
    sum in a run-dependent order) for CUDA tensors, the plain version for
    CPU tensors."""
    if not g.is_cuda:
        return scatter_rows_add_plain(g, idx, n)
    idx = idx.to(torch.int32).contiguous()
    _check_rows("scatter_rows_add", g, idx)
    B, M, D = g.shape
    dx = torch.empty((B, n, D), dtype=torch.float32, device=g.device)
    cuda_lib.launch("scatter_rows_add", "r3dl_scatter_rows_add",
                    g.data_ptr(), idx.data_ptr(), dx.data_ptr(), B, n, M, D)
    return dx


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[1]
        if not x.is_cuda:
            return gather_rows_plain(x, idx)
        return _gather_kernel(x, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return scatter_rows_add(g.contiguous(), idx, ctx.n), None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors; differentiable in x (backward: scatter_rows_add). idx
    must be in range (no clamping, no sentinel rows)."""
    if x.is_cuda:
        idx = idx.to(torch.int32).contiguous()
        x = x.contiguous()
    return _GatherRows.apply(x, idx)


# ------------------------------------------------ K9 / K10: small C -------

SMALLC_MAX = 32


def gather_rows_smallc_plain(x: torch.Tensor, idx: torch.Tensor):
    """x (B, N, C), idx (B, M) any int -> (B, M, C); rows whose index is
    outside [0, N) are zero."""
    N = x.shape[1]
    valid = (idx >= 0) & (idx < N)
    g = gather_rows_plain(x, idx.long().clamp(0, N - 1))
    return torch.where(valid[..., None], g, torch.zeros_like(g))


def scatter_rows_smallc_add_plain(g: torch.Tensor, idx: torch.Tensor,
                                  n: int) -> torch.Tensor:
    """g (B, M, C), idx (B, M) any int -> (B, n, C) fp32 with
    out[b, idx[b, m]] += g[b, m] for idx in [0, n); other rows dropped."""
    valid = (idx >= 0) & (idx < n)
    gv = torch.where(valid[..., None], g, torch.zeros_like(g))
    return scatter_rows_add_plain(gv, idx.long().clamp(0, n - 1), n)


def _check_smallc(name, x, idx):
    _check_rows(name, x, idx)
    if x.shape[-1] > SMALLC_MAX:
        raise ValueError(f"{name}: {x.shape[-1]} channels > {SMALLC_MAX}")


def _gather_smallc_kernel(x, idx):
    _check_smallc("gather_rows_smallc", x, idx)
    B, N, C = x.shape
    M = idx.shape[1]
    out = torch.empty((B, M, C), dtype=x.dtype, device=x.device)
    cuda_lib.launch("gather_rows_smallc", "r3dl_gather_smallc", x.data_ptr(),
                    idx.data_ptr(), out.data_ptr(), B, N, M, C)
    return out


def scatter_rows_smallc_add(g: torch.Tensor, idx: torch.Tensor, n: int):
    """K10: the CUDA kernel (fp32 atomicAdd) for CUDA tensors, the plain
    version for CPU tensors; rows whose index is outside [0, n) drop."""
    if not g.is_cuda:
        return scatter_rows_smallc_add_plain(g, idx, n)
    idx = idx.to(torch.int32).contiguous()
    _check_smallc("scatter_rows_smallc_add", g, idx)
    B, M, C = g.shape
    dx = torch.empty((B, n, C), dtype=torch.float32, device=g.device)
    cuda_lib.launch("scatter_rows_smallc_add", "r3dl_scatter_smallc_add",
                    g.data_ptr(), idx.data_ptr(), dx.data_ptr(), B, n, M, C)
    return dx


class _GatherRowsSmallC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[1]
        if not x.is_cuda:
            return gather_rows_smallc_plain(x, idx)
        return _gather_smallc_kernel(x, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return scatter_rows_smallc_add(g.contiguous(), idx, ctx.n), None


def gather_rows_smallc(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K9: row gather of at most 32 channels with sentinel rows (an index
    outside [0, N), such as N, gathers zeros); the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; differentiable in x
    (backward: K10)."""
    if x.is_cuda:
        idx = idx.to(torch.int32).contiguous()
        x = x.contiguous()
    return _GatherRowsSmallC.apply(x, idx)


def permute_rows_any(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Width-aware row gather with in-range indices (pallas_gather.py
    `permute_rows_any`): K9 for rows of at most 32 channels, K4
    otherwise."""
    if x.shape[-1] <= SMALLC_MAX:
        return gather_rows_smallc(x, idx)
    return gather_rows(x, idx)
