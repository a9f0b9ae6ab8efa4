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
input features; scatter_rows_smallc_add is also the stem conv's input
gradient (ops/stem.py). The CUDA kernels are in csrc/gather.cu and
csrc/gather_smallc.cu; the *_plain functions are the same functions in
PyTorch, the path for CPU tensors and the oracles the kernels are held
against. scatter_smallc_plan is K10's block plan (ranges of row tiles per
cloud, slabs of destination rows), plain Python that the CPU tests
enumerate.

K4 and K9 also take bf16 rows (the activations under compute_dtype
bfloat16): a launch of their 2-byte entry points (csrc r3dl_gather_rows16,
r3dl_gather_smallc16), counted as gather_rows_bf16 /
gather_rows_smallc_bf16; a copy, so bit-equal to the plain version. K8 and
K10 take fp32 only (bf16 training raises before it reaches them).

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
_F32, _BF16 = torch.float32, torch.bfloat16
_I32, _I64 = torch.int32, torch.int64
_GATHER_DTYPES = (_F32, _BF16)     # what K4 and K9 take
_SCATTER_DTYPES = (_F32,)          # what K8 and K10 take


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


def _check_failed(name, x, idx, max_width, dtypes=_GATHER_DTYPES):
    width = "D" if max_width >= _ANY_WIDTH else f"D <= {max_width}"
    kinds = " or ".join(str(d).replace("torch.", "") for d in dtypes)
    return ValueError(
        f"{name}: expected contiguous CUDA tensors x {kinds} (B, N, "
        f"{width}) and idx int32 or int64 (B, M); got x {x.dtype} "
        f"{tuple(x.shape)} on {x.device}, idx {idx.dtype} "
        f"{tuple(idx.shape)} on {idx.device}")


def _checked(kernel, max_width, x, idx, dtypes=_GATHER_DTYPES):
    """The one check of what the gather kernels take: x of one of `dtypes`
    (B, N, D <= max_width), idx int32 or int64 (B, M), both CUDA (made
    contiguous here); returns x, idx, B, N, D, M and whether idx is
    int64."""
    if not (x.is_contiguous() and idx.is_contiguous()):
        x, idx = x.contiguous(), idx.contiguous()
    try:
        B, N, D = x.shape
        Bi, M = idx.shape
    except ValueError:
        raise _check_failed(kernel, x, idx, max_width, dtypes) from None
    idx64 = idx.dtype is _I64
    if x.dtype not in dtypes or not (idx64 or idx.dtype is _I32) or \
            Bi != B or D > max_width or not idx.is_cuda:
        raise _check_failed(kernel, x, idx, max_width, dtypes)
    return x, idx, B, N, D, M, idx64


# the bf16 entry points and counters of K4 and K9
_BF16_ROUTES = {"r3dl_gather_rows": ("gather_rows_bf16",
                                     "r3dl_gather_rows16"),
                "r3dl_gather_smallc": ("gather_rows_smallc_bf16",
                                       "r3dl_gather_smallc16")}


def _launch(kernel, c_name, max_width, x, idx, n=None):
    """One launch of K4 / K9 (n None: out (B, M, D) = x[b, idx], x fp32 or
    bf16) or of K8 (x the fp32 cotangent (B, M, D): out (B, n, D)). It is
    the whole host path of a call, so it stays flat: one check, one
    allocation, one ctypes call."""
    dtypes = _GATHER_DTYPES if n is None else _SCATTER_DTYPES
    x, idx, B, N, D, M, idx64 = _checked(kernel, max_width, x, idx, dtypes)
    if n is None:
        out = x.new_empty(B, M, D)
        if x.dtype is _BF16:
            kernel, c_name = _BF16_ROUTES[c_name]
    elif M != N:
        raise _check_failed(kernel, x, idx, max_width, dtypes)
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


# K10's plan constants (csrc/gather_smallc.cu)
SMALLC_TILE_ROWS = 1024          # kTileRows: ranges split whole tiles
SMALLC_SMEM = 227 * 1024         # shared memory an H100 block may hold
SMALLC_SM_SMEM = 228 * 1024      # shared memory of an SM
SMALLC_SMS = 132                 # the H100's SMs


def scatter_smallc_smem(C: int, window: int) -> int:
    """Shared memory of a K10 block: its window x C copy of dx."""
    return -(-4 * window * C // 16) * 16


def scatter_smallc_blocks_per_sm(C: int, window: int) -> int:
    """K10 blocks an SM holds: two (its 32-register bound) where both
    copies fit beside the 1 KB the card reserves a block, else one."""
    return 2 if 2 * (scatter_smallc_smem(C, window) + 1024) <= \
        SMALLC_SM_SMEM else 1


def scatter_smallc_plan(B: int, M: int, n: int, C: int):
    """K10's (ranges, window). A block holds a private copy of `window`
    destination rows (a slab; all C channels) of one cloud's dx in shared
    memory: the widest slab that fits, split evenly, so n = 4096 is one
    slab up to C = 14. Each cloud's 1024-row tiles are split into `ranges`
    runs (scatter_smallc_ranges) so that the B x slabs x ranges blocks
    about fill the SMs (two blocks an SM where two fit, so 8 ranges at
    B = 32 and C <= 7), at most M // (2 n) (the partials' writes under
    half of g's bytes) and at most the tiles; with ranges > 1 the runs'
    partials add in order in a second kernel."""
    cap = SMALLC_SMEM // (4 * max(C, 1))
    slabs = max(1, -(-n // cap))
    window = max(1, -(-n // slabs))
    tiles = -(-M // SMALLC_TILE_ROWS)
    blocks = SMALLC_SMS * scatter_smallc_blocks_per_sm(C, window)
    ranges = max(1, min(blocks // max(1, B * slabs),
                        M // (2 * max(n, 1)), tiles))
    return ranges, window


def scatter_smallc_ranges(M: int, ranges: int):
    """[(row_begin, row_end)] of each range's run of tiles, as
    csrc/gather_smallc.cu splits them: range r holds tiles
    [r nt // ranges, (r + 1) nt // ranges) of nt = ceil(M / 1024)."""
    T = SMALLC_TILE_ROWS
    nt = -(-M // T)
    return [(min(M, r * nt // ranges * T), min(M, (r + 1) * nt // ranges * T))
            for r in range(ranges)]


def scatter_rows_smallc_add(g: torch.Tensor, idx: torch.Tensor, n: int):
    """K10: the CUDA kernel (private shared-memory copies of dx, no global
    atomics; sums agree with a fixed-order sum to rounding) for CUDA
    tensors, the plain version for CPU tensors; rows whose index is
    outside [0, n) drop."""
    if not g.is_cuda:
        return scatter_rows_smallc_add_plain(g, idx, n)
    plan = scatter_smallc_plan(g.shape[0], g.shape[1], n, g.shape[-1])
    return scatter_rows_smallc_add_split(g, idx, n, *plan)


def scatter_rows_smallc_add_split(g, idx, n, ranges, window):
    """K10 on CUDA tensors with a given plan (scatter_smallc_plan gives
    scatter_rows_smallc_add's); one launch count (two kernels when
    ranges > 1)."""
    g, idx, B, M, C, Mi, idx64 = _checked("scatter_rows_smallc_add",
                                          SMALLC_MAX, g, idx,
                                          _SCATTER_DTYPES)
    if Mi != M:
        raise _check_failed("scatter_rows_smallc_add", g, idx, SMALLC_MAX,
                            _SCATTER_DTYPES)
    if not (ranges >= 1 and window >= 1 and
            (ranges == 1 or ranges <= -(-M // SMALLC_TILE_ROWS)) and
            scatter_smallc_smem(C, window) <= SMALLC_SMEM):
        raise ValueError(f"scatter_rows_smallc_add: plan ({ranges} ranges, "
                         f"window {window}) for M = {M}, n = {n}, C = {C}")
    out = g.new_empty(B, n, C)
    work = g.new_empty(ranges * out.numel()) if ranges > 1 else None
    cuda_lib.launch("scatter_rows_smallc_add", "r3dl_scatter_smallc_add",
                    g.data_ptr(), idx.data_ptr(), out.data_ptr(),
                    None if work is None else work.data_ptr(), B, n, M, C,
                    idx64, ranges, window,
                    0 if work is None else 4 * work.numel())
    return out


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
    N, gathers a zero row); x fp32 or bf16, idx int32 or int64. The CUDA
    kernel for CUDA
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
