"""K4, batched row gather, and K8, its backward (port of
robot3dlotus_tpu/ops/pallas_gather.py `permute_rows` and the custom VJP
`_permute_op`): out[b, m] = x[b, idx[b, m]], and the cotangent
dx[b, idx[b, m]] += g[b, m].

gather_rows serves patching.gather_sorted / scatter_back, the decoder's
unpool_gather (ops/pooling.py) and the entry sorts (models/ptv3.py); it is
differentiable, with K8 as its backward. The CUDA kernels are in
csrc/gather.cu; gather_rows_plain and scatter_rows_add_plain are the same
functions in PyTorch, the path for CPU tensors and the oracles the kernels
are held against.
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
