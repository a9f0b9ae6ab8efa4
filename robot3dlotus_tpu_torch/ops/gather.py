"""K4, batched row gather, and K8, its backward (port of
robot3dlotus_tpu/ops/pallas_gather.py `permute_rows` and the custom VJP
`_permute_op`): out[b, m] = x[b, idx[b, m]], and the cotangent
dx[b, idx[b, m]] += g[b, m]. K9 and K10 are the same pair for rows of at
most 32 channels (`gather_rows_smallc` and its custom VJP `_smallc_op`).
All four take sentinel rows: an index outside [0, N) gathers a zero row,
and its cotangent is dropped. The TPU's K4 took only indices in [0, N);
the port's unpool_gather relies on the sentinel instead of a padded copy.

gather_rows serves patching.gather_sorted / scatter_back, the decoder's
unpool_gather (ops/pooling.py, child_cap = dropped) and the pooled stages'
entry sorts (models/ptv3.py); gather_rows_smallc serves the motion
planner's categorical stem (ops/sparse_conv.py, idx == N where a neighbour
is missing) and, through permute_rows_any, the stage-0 entry sort of the
input features. The CUDA kernels are in csrc/gather.cu and
csrc/gather_smallc.cu; the *_plain functions are the same functions in
PyTorch, the path for CPU tensors and the oracles the kernels are held
against.

Indices are int32 or int64 and reach the kernels as they are (no cast).
A CUDA call that carries no gradient (grad mode off, or x not requiring
one) launches its kernel directly; otherwise an autograd Function carries
it, with K8 / K10 as its backward.
"""
from __future__ import annotations

import torch

from . import cuda_lib

SMALLC_MAX = 32
_ANY_WIDTH = 1 << 30
_F32, _I32, _I64 = torch.float32, torch.int32, torch.int64


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D), idx (B, M) any int -> (B, M, D); rows whose index is
    outside [0, N) are zero."""
    N = x.shape[1]
    idx = idx.long()
    valid = (idx >= 0) & (idx < N)
    g = torch.gather(x, 1, idx.clamp(0, N - 1)[..., None].expand(
        -1, -1, x.shape[-1]))
    return torch.where(valid[..., None], g, torch.zeros_like(g))


def scatter_rows_add_plain(g: torch.Tensor, idx: torch.Tensor,
                           n: int) -> torch.Tensor:
    """g (B, M, D), idx (B, M) any int -> (B, n, D) fp32 with
    out[b, idx[b, m]] += g[b, m] for idx in [0, n) (colliding indices
    sum); other rows dropped."""
    B, M, D = g.shape
    idx = idx.long()
    valid = (idx >= 0) & (idx < n)
    gv = torch.where(valid[..., None], g.float(), 0.0)
    out = torch.zeros((B, n, D), dtype=torch.float32, device=g.device)
    return out.scatter_add_(1, idx.clamp(0, n - 1)[..., None].expand(
        B, M, D), gv)


# K9 / K10 compute the same functions for rows of at most SMALLC_MAX
gather_rows_smallc_plain = gather_rows_plain
scatter_rows_smallc_add_plain = scatter_rows_add_plain


def _check_failed(name, x, idx, max_width):
    width = "D" if max_width >= _ANY_WIDTH else f"D <= {max_width}"
    return ValueError(
        f"{name}: expected contiguous CUDA tensors x float32 (B, N, {width}) "
        f"and idx int32 or int64 (B, M); got x {x.dtype} {tuple(x.shape)} "
        f"on {x.device}, idx {idx.dtype} {tuple(idx.shape)} on "
        f"{idx.device}")


def _launch(kernel, c_name, max_width, x, idx, n=None):
    """One launch of K4 / K9 (n None: out (B, M, D) = x[b, idx]) or of K8 /
    K10 (x the cotangent (B, M, D): out (B, n, D)), with the one check of
    what the kernels take: x fp32 (B, N, D <= max_width), idx int32 or
    int64 (B, M), both CUDA (made contiguous here). It is the whole host
    path of a call, so it stays flat: one allocation, one ctypes call."""
    if not (x.is_contiguous() and idx.is_contiguous()):
        x, idx = x.contiguous(), idx.contiguous()
    try:
        B, N, D = x.shape
        Bi, M = idx.shape
    except ValueError:
        raise _check_failed(kernel, x, idx, max_width) from None
    idx64 = idx.dtype is _I64
    if x.dtype is not _F32 or not (idx64 or idx.dtype is _I32) or \
            Bi != B or D > max_width or not idx.is_cuda:
        raise _check_failed(kernel, x, idx, max_width)
    if n is None:
        out = x.new_empty(B, M, D)
    elif M != N:
        raise _check_failed(kernel, x, idx, max_width)
    else:
        out = x.new_empty(B, n, D)
        N = n
    cuda_lib.launch(kernel, c_name, x.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), B, N, M, D, idx64)
    return out


def scatter_rows_add(g: torch.Tensor, idx: torch.Tensor, n: int):
    """K8, row scatter-add that drops rows whose index is outside [0, n):
    the CUDA kernel (fp32 atomicAdd, so colliding rows sum in a
    run-dependent order) for CUDA tensors, the plain version for CPU
    tensors."""
    if not g.is_cuda:
        return scatter_rows_add_plain(g, idx, n)
    return _launch("scatter_rows_add", "r3dl_scatter_rows_add", _ANY_WIDTH,
                   g, idx, n)


def scatter_rows_smallc_add(g: torch.Tensor, idx: torch.Tensor, n: int):
    """K10: the CUDA kernel (fp32 atomicAdd) for CUDA tensors, the plain
    version for CPU tensors; rows whose index is outside [0, n) drop."""
    if not g.is_cuda:
        return scatter_rows_smallc_add_plain(g, idx, n)
    return _launch("scatter_rows_smallc_add", "r3dl_scatter_smallc_add",
                   SMALLC_MAX, g, idx, n)


# (launch counter, C entry point, widest row) of K4 and of K9
_K4 = ("gather_rows", "r3dl_gather_rows", _ANY_WIDTH)
_K9 = ("gather_rows_smallc", "r3dl_gather_smallc", SMALLC_MAX)
_BACKWARD = {_K4: scatter_rows_add, _K9: scatter_rows_smallc_add}


class _Gather(torch.autograd.Function):
    """K4 or K9 (`spec`) with K8 or K10 as its backward."""

    @staticmethod
    def forward(ctx, x, idx, spec):
        ctx.save_for_backward(idx)
        ctx.n, ctx.spec = x.shape[1], spec
        if not x.is_cuda:
            return gather_rows_plain(x, idx)
        return _launch(*spec, x, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return _BACKWARD[ctx.spec](g, idx, ctx.n), None, None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K4: row gather with sentinel rows (an index outside [0, N), such as
    N, gathers a zero row); idx int32 or int64. The CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; differentiable in x
    (backward: K8, which drops the sentinel rows' cotangents). A CUDA call
    that carries no gradient launches the kernel directly; every other call
    goes through the autograd Function."""
    if x.is_cuda and not (x.requires_grad and torch.is_grad_enabled()):
        return _launch(*_K4, x, idx)
    return _Gather.apply(x, idx, _K4)


def gather_rows_smallc(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K9: gather_rows for rows of at most 32 channels; the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors; differentiable in x
    (backward: K10)."""
    if x.is_cuda and not (x.requires_grad and torch.is_grad_enabled()):
        return _launch(*_K9, x, idx)
    return _Gather.apply(x, idx, _K9)


def permute_rows_any(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Width-aware row gather (pallas_gather.py `permute_rows_any`): K9 for
    rows of at most 32 channels, K4 otherwise."""
    if x.shape[-1] <= SMALLC_MAX:
        return gather_rows_smallc(x, idx)
    return gather_rows(x, idx)
