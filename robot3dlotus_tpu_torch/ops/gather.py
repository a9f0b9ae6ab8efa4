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
cloud, slabs of destination rows), smallc16_plan / smallc16_row_words
K9's at bf16 and scatter_smallc16_chunks K10's warp chunks at bf16: plain
Python that the CPU tests enumerate.

K4 and K9 also take bf16 rows (the activations under compute_dtype
bfloat16): a launch of their 2-byte entry points (csrc r3dl_gather_rows16,
r3dl_gather_smallc16), counted as gather_rows_bf16 /
gather_rows_smallc_bf16; a copy, so bit-equal to the plain version (K9's
bf16 kernel reads each row whole as the 8-byte words that cover it). K8
takes a bf16 cotangent too (csrc r3dl_scatter_rows_add_bf16, counted as
scatter_rows_add_bf16): the rows are widened and summed in fp32, and the
sums are rounded to bf16 once (the rule of pallas_gather.py
`_permute_op_bwd`: fp32 sum, one rounding to the input's dtype), or handed
back in fp32 where the caller sums on (the conv's owner sum, ops/conv.py).
At both dtypes K8 is one kernel a call that owns tiles of destination rows
(csrc/gather.cu): each destination sums its sources in increasing row
order from 0 in fp32 and is written once, so the result is bit-equal from
launch to launch and needs no zeroed buffer (scatter_rows_add_ordered is
that order in PyTorch).
K10 takes a bf16 cotangent the same way (csrc r3dl_scatter_smallc_add_bf16,
counted as scatter_rows_smallc_add_bf16: fp32 sums, one rounding, the rule
of pallas_gather.py `_smallc_op_bwd`; up to C = 8 a kernel of its own that
lists each warp's live rows and adds a row on C lanes); the stems' input
gradients at bf16 reach it (no training step of either family does: the
stems gather data).

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
_SCATTER_DTYPES = (_F32, _BF16)    # what K8 and K10 take


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
    sum in fp32, a bf16 g widened); other rows dropped."""
    B, M, D = g.shape
    idx = idx.long()
    valid = (idx >= 0) & (idx < n)
    gv = torch.where(valid[..., None], g.float(), 0.0)
    out = torch.zeros((B, n, D), dtype=torch.float32, device=g.device)
    return out.scatter_add_(1, idx.clamp(0, n - 1)[..., None].expand(
        B, M, D), gv)


def scatter_rows_add_ordered(g: torch.Tensor, idx: torch.Tensor,
                             n: int) -> torch.Tensor:
    """scatter_rows_add_plain in K8's order of adds: every destination row
    sums its sources in increasing source row order, starting from 0, in
    fp32 (round k adds each row's k-th source, as the kernel's rounds do);
    for the CPU tests, slow."""
    B, M, D = g.shape
    idx = idx.long()
    out = torch.zeros((B, n, D), dtype=torch.float32, device=g.device)
    for b in range(B):
        live = ((idx[b] >= 0) & (idx[b] < n)).nonzero()[:, 0]
        dest = idx[b, live]
        order = torch.argsort(dest, stable=True)
        src, dest = live[order], dest[order]
        first = torch.searchsorted(dest, dest, right=False)
        rank = torch.arange(dest.numel(), device=g.device) - first
        for k in range(int(rank.max()) + 1 if rank.numel() else 0):
            sel = rank == k
            out[b, dest[sel]] += g[b, src[sel]].float()
    return out


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


def _launch(kernel, c_name, max_width, x, idx, n=None, dtype=None):
    """One launch of K4 / K9 (n None: out (B, M, D) = x[b, idx], x fp32 or
    bf16) or of K8 (x the cotangent (B, M, D), fp32 or bf16: out (B, n, D)
    of `dtype`, x's by default; a bf16 x may ask for the fp32 sums). It is
    the whole host path of a call, so it stays flat: one check, one or two
    allocations, one ctypes call."""
    dtypes = _GATHER_DTYPES if n is None else _SCATTER_DTYPES
    x, idx, B, N, D, M, idx64 = _checked(kernel, max_width, x, idx, dtypes)
    if n is None:
        out = x.new_empty(B, M, D)
        if x.dtype is _BF16:
            kernel, c_name = _BF16_ROUTES[c_name]
    elif M != N or (dtype or x.dtype) not in (x.dtype, _F32):
        raise _check_failed(kernel, x, idx, max_width, dtypes)
    elif x.dtype is _BF16:
        # the fp32 sums rounded to bf16, or the sums where the caller takes
        # them (dtype float32); every element written by the kernel
        f32 = dtype is _F32
        out = x.new_empty(B, n, D, dtype=_F32 if f32 else _BF16)
        cuda_lib.launch("scatter_rows_add_bf16", "r3dl_scatter_rows_add_bf16",
                        x.data_ptr(), idx.data_ptr(), out.data_ptr(), int(f32),
                        B, n, M, D, idx64)
        return out
    else:
        out = x.new_empty(B, n, D)
        N = n
    cuda_lib.launch(kernel, c_name, x.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), B, N, M, D, idx64)
    return out


def scatter_rows_add(g: torch.Tensor, idx: torch.Tensor, n: int,
                     dtype=None):
    """K8, row scatter-add that drops rows whose index is outside [0, n),
    g fp32 or bf16, summed in fp32 and returned in `dtype` (g's by
    default; float32 for a bf16 g returns the sums unrounded): the CUDA
    kernel (each destination's sources in increasing row order, bit-equal
    from launch to launch) for CUDA tensors, the plain version for CPU
    tensors."""
    if not g.is_cuda:
        return scatter_rows_add_plain(g, idx, n).to(dtype or g.dtype)
    return _launch("scatter_rows_add", "r3dl_scatter_rows_add", _ANY_WIDTH,
                   g, idx, n, dtype)


def smallc16_plan(M: int, C: int):
    """K9's bf16 plan (csrc/gather_smallc.cu gather_smallc16_kernel): (tile
    rows, threads, blocks a cloud). A thread gathers 4 consecutive rows,
    so a block's output of 2 C x rows bytes is staged in 32 KB at most:
    1024-row tiles up to C = 16, 512 above."""
    tile = 1024 if C <= 16 else 512
    return tile, tile // 4, -(-M // tile)


def smallc16_row_words(C: int):
    """(words, pairs) of a bf16 row of C channels, as
    gather_smallc16_kernel reads it: the row starts at element
    (b N + i) C of x, 0, 2, 4 or 6 bytes into an 8-byte word of x's
    aligned base, so at most `words` 8-byte loads cover it, shifted into
    `pairs` 32-bit words of two channels."""
    return (2 * C + 6 + 7) // 8, (C + 1) // 2


# K10's plan constants (csrc/gather_smallc.cu)
SMALLC_TILE_ROWS = 1024          # kTileRows: ranges split whole tiles
SMALLC_SMEM = 227 * 1024         # shared memory an H100 block may hold
SMALLC_SM_SMEM = 228 * 1024      # shared memory of an SM
SMALLC_SMS = 132                 # the H100's SMs


# K10 at bf16 up to C = 8 (scatter_smallc16_kernel): 32 warps a block,
# each staging a 128-row chunk of g and a list of its live rows beside the
# block's copy of dx
SMALLC16_MAX = 8
SMALLC16_WARPS = 32
SMALLC16_CHUNK = 128


def scatter_smallc16_warp_smem(C: int) -> int:
    """A bf16 K10 warp's shared memory: its chunk of g (128 rows x 2 C
    bytes) and its list of the chunk's live rows (4 bytes each)."""
    return SMALLC16_CHUNK * (2 * C + 4)


def scatter_smallc16_chunks(m0: int, m1: int):
    """The chunks of a bf16 K10 block's range of rows [m0, m1), by warp:
    warp w takes [c, min(c + 128, m1)) for c = m0 + 128 w, stepping by
    32 x 128; lane l of a chunk holds the indices of rows c + 4 l ..
    c + 4 l + 3."""
    step = SMALLC16_WARPS * SMALLC16_CHUNK
    return [[(c, min(c + SMALLC16_CHUNK, m1))
             for c in range(m0 + w * SMALLC16_CHUNK, m1, step)]
            for w in range(SMALLC16_WARPS)]


def _list16(C, bf16):
    return bf16 and C <= SMALLC16_MAX


def scatter_smallc_smem(C: int, window: int, bf16: bool = False) -> int:
    """Shared memory of a K10 block: its window x C fp32 copy of dx, and
    at bf16 up to C = 8 its warps' staged chunks and lists."""
    return -(-4 * window * C // 16) * 16 + (
        SMALLC16_WARPS * scatter_smallc16_warp_smem(C)
        if _list16(C, bf16) else 0)


def scatter_smallc_blocks_per_sm(C: int, window: int,
                                 bf16: bool = False) -> int:
    """K10 blocks an SM holds: two (its 32-register bound) where both
    copies fit beside the 1 KB the card reserves a block, else one; one
    at bf16 up to C = 8 (a 32-warp block, 64 registers a thread, whose
    shared memory holds the slab and its warps' chunks)."""
    if _list16(C, bf16):
        return 1
    return 2 if 2 * (scatter_smallc_smem(C, window) + 1024) <= \
        SMALLC_SM_SMEM else 1


def scatter_smallc_plan(B: int, M: int, n: int, C: int, bf16: bool = False):
    """K10's (ranges, window). A block holds a private copy of `window`
    destination rows (a slab; all C channels) of one cloud's dx in shared
    memory: the widest slab that fits, split evenly, so n = 4096 is one
    slab up to C = 14 (C = 8 at bf16, beside the lists). Each cloud's
    1024-row tiles are split into `ranges` runs (scatter_smallc_ranges)
    so that the B x slabs x ranges blocks about fill the SMs (two blocks
    an SM where two fit, so 8 ranges at B = 32 and C <= 7; one at bf16 up
    to C = 8, so 4), at most M // (2 n) (the partials' writes under half
    of g's bytes) and at most the tiles; with ranges > 1 the runs'
    partials add in order in a second kernel."""
    warps = SMALLC16_WARPS * scatter_smallc16_warp_smem(C) \
        if _list16(C, bf16) else 0
    cap = (SMALLC_SMEM - warps) // (4 * max(C, 1))
    slabs = max(1, -(-n // cap))
    window = max(1, -(-n // slabs))
    tiles = -(-M // SMALLC_TILE_ROWS)
    blocks = SMALLC_SMS * scatter_smallc_blocks_per_sm(C, window, bf16)
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
    outside [0, n) drop. g fp32 or bf16, summed in fp32, returned in g's
    dtype (a bf16 dx rounded once)."""
    if not g.is_cuda:
        return scatter_rows_smallc_add_plain(g, idx, n).to(g.dtype)
    plan = scatter_smallc_plan(g.shape[0], g.shape[1], n, g.shape[-1],
                               g.dtype is _BF16)
    return scatter_rows_smallc_add_split(g, idx, n, *plan)


def scatter_rows_smallc_add_split(g, idx, n, ranges, window):
    """K10 on CUDA tensors with a given plan (scatter_smallc_plan gives
    scatter_rows_smallc_add's); one launch count (two kernels when
    ranges > 1). The ranges' partials are fp32 at either dtype."""
    g, idx, B, M, C, Mi, idx64 = _checked("scatter_rows_smallc_add",
                                          SMALLC_MAX, g, idx,
                                          _SCATTER_DTYPES)
    if Mi != M:
        raise _check_failed("scatter_rows_smallc_add", g, idx, SMALLC_MAX,
                            _SCATTER_DTYPES)
    if not (ranges >= 1 and window >= 1 and
            (ranges == 1 or ranges <= -(-M // SMALLC_TILE_ROWS)) and
            scatter_smallc_smem(C, window, g.dtype is _BF16) <=
            SMALLC_SMEM):
        raise ValueError(f"scatter_rows_smallc_add: plan ({ranges} ranges, "
                         f"window {window}) for M = {M}, n = {n}, C = {C}")
    out = g.new_empty(B, n, C)
    work = g.new_empty(ranges * out.numel(), dtype=_F32) \
        if ranges > 1 else None
    kernel, entry = ("scatter_rows_smallc_add_bf16",
                     "r3dl_scatter_smallc_add_bf16") if g.dtype is _BF16 \
        else ("scatter_rows_smallc_add", "r3dl_scatter_smallc_add")
    cuda_lib.launch(kernel, entry, g.data_ptr(), idx.data_ptr(),
                    out.data_ptr(),
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
    rows of at most 32 channels, K4 otherwise, at either dtype (the
    backwards K10 and K8 both sum in fp32 and round once)."""
    if x.shape[-1] <= SMALLC_MAX:
        return gather_rows_smallc(x, idx)
    return gather_rows(x, idx)
