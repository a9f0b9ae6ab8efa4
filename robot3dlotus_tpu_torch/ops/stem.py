"""K3, the fused k=5 stem conv (port of robot3dlotus_tpu/ops/pallas_stem.py
`stem_gather_windowed` plus the stencil einsum that followed it,
ops/sparse_conv.py:298), and its weight gradient.

out[b, n] = sum_k ok[b, n, k] * W[k]^T x[b, idx[b, n, k]] for Cin <= 8 and
no bias (BN and GELU follow in the model). The CUDA kernel is csrc/stem.cu
and gathers and multiplies the live links in one pass, on the tensor cores
as 3xTF32; stem_conv_plain is the same function in PyTorch (the
gather-then-einsum form), the path for CPU tensors and the kernel's oracle.
stem_conv_plan splits the work over blocks: a training batch runs one
block per SM holding the whole weight; a B = 1 cloud's row groups are too
few to fill the card, so its taps are split over blocks whose partials a
second kernel adds in a fixed order (two launches for one count). Either
way a row sums its taps in one order at every batch size: the taps are
cut into sum ranges of STEM_RANGE_TAPS (stem_sum_ranges, a function of K
alone), each range summed into a fresh fp32 partial and the partials
added from 0 in range order, by the block that holds the whole row or by
the second kernel (one sum range a block), so that predict_batch of a
cloud equals its predict bit for bit.

bf16 (compute_dtype bfloat16): x and W bf16 on the bf16 tensor cores, one
mma.sync.m16n8k16 a live pair of taps (k = 2 taps x 8 channels), the taps
summed in fp32 and the output rounded to bf16 once (csrc
r3dl_stem_conv_bf16, counted as stem_conv_bf16; the tap ranges' partials
stay fp32, and a bf16 chunk is one sum range). Its rows are gathered 16
bytes a link, so x's rows are padded
to 8 channels by a first kernel of the same call into a scratch this
wrapper allocates (none at Cin = 8), and a Cout that is not a multiple of
8 gets zero weight columns here (dropped from the output). The weight gradient
at bf16 is K7's bf16 path (fp32 sums of the bf16 products, rounded to
bf16 once by the caller). The input gradient at bf16 rounds where the
JAX VJP rounds (the einsum's VJP, then pallas_stem.py
`_windowed_gather_bwd`): G = g W^T summed in fp32 and rounded to bf16 per
(row, tap), then K10's bf16 path (fp32 sums, one rounding). No training
step runs it: the policy's stem input is data.

Backward: dW is K7 (ops/conv.py conv_weight_grad) at the stem's shape.
The input gradient (stem_input_grad) takes the JAX package's two steps:
the stencil product's VJP, G = g W^T for every (row, tap), one matmul
outside any kernel as the JAX package leaves it to XLA
(ops/sparse_conv.py:298), then the gather's VJP, K10 (ops/gather.py
scatter_rows_smallc_add, the port of pallas_stem.py `_windowed_gather_bwd`
-> `_smallc_bwd_call`), which adds the (B, N K, Cin) G onto (B, N, Cin)
with every dead link pointed at the sentinel row N, so that it drops. The
policy's stem input is data, so its training step runs neither; the
motion planner's stem goes through K9 and K10 instead
(ops/sparse_conv.py categorical_conv).
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .conv import _aligned, _pad_channels, conv_weight_grad
from .gather import scatter_rows_smallc_add

MAX_CIN = 8
STEM_RANGE_TAPS = 16             # csrc/stem.cu kRangeTaps: a sum range
# csrc/stem.cu kWarpSmem16: a bf16 warp's A tile of a tap pair (512
# bytes) and its map tile (16 rows x 18 ints)
STEM_WARP_SMEM_BYTES = 512 + 16 * 18 * 4
STEM_ROWS_PER_WARP = 16          # the mma's m
STEM_MAX_WARPS = 16              # csrc/stem.cu kMaxWarps
STEM_MAX_SMEM = 227 * 1024       # shared memory an H100 block may hold
STEM_SMS = 132                   # the H100's SMs


def stem_conv_plain(x, idx, ok, weight):
    """x (B, N, Cin); idx/ok (B, N, K); weight (K, Cin, Cout); summed in
    fp32 (bf16 operands widened), cast to x's dtype once."""
    B, N, C = x.shape
    K = idx.shape[-1]
    g = torch.gather(x, 1, idx.reshape(B, N * K).long()[..., None].expand(
        -1, -1, C)).reshape(B, N, K, C)
    g = torch.where(ok[..., None], g, torch.zeros_like(g))
    return torch.einsum("bnkc,kcd->bnd", g.float(),
                        weight.float()).to(x.dtype)


def stem_conv_plan(B, N, K, cin, cout, bf16=False):
    """K3's (cols, warps, splits, blocks). A block owns `cols` output
    channels (64; 32 at Cin = 8 in fp32, where 64 columns of 125 taps'
    weight would not fit its shared memory) and block range s of `splits`
    (stem_tap_ranges); its `warps` warps take the B N rows (flat over the
    clouds) in 16-row groups, group blockIdx.x warps + warp + i blocks
    warps. Blocks are 16 warps (the weight slice is staged once per 256
    rows). Where every warp of one block per SM then gets two groups or
    more (a training batch), that: each SM loads the weight once, and the
    block sums every range of a row. Else one group a warp, and one sum
    range a block (a B = 1 cloud: 8 ranges of 16 taps). Only these two
    split counts keep a row's order of sums (stem_sum_ranges)."""
    cols = 64 if cin <= 7 or bf16 else 32
    col_tiles = -(-cout // cols)
    groups = -(-B * N // STEM_ROWS_PER_WARP)
    warps = min(STEM_MAX_WARPS, groups)
    blocks = -(-groups // warps)
    per_sm = -(-STEM_SMS // col_tiles)
    if blocks >= 2 * per_sm:
        return cols, warps, 1, per_sm
    return cols, warps, len(stem_sum_ranges(K)), blocks


def stem_sum_ranges(K):
    """[(k_begin, k_end)]: the sum ranges of a row's K taps, STEM_RANGE_TAPS
    each (the last may be shorter), whose fp32 partials csrc/stem.cu adds
    from 0 in this order at every plan stem_conv_plan picks."""
    return [(k, min(K, k + STEM_RANGE_TAPS))
            for k in range(0, K, STEM_RANGE_TAPS)]


def stem_tap_ranges(K, splits):
    """[(k_begin, k_end)] per block range: range s holds the sum ranges
    [s NR // splits, (s + 1) NR // splits) of NR = len(stem_sum_ranges(K))
    (1 <= splits <= NR), as csrc/stem.cu splits them."""
    NR = len(stem_sum_ranges(K))
    return [(min(K, s * NR // splits * STEM_RANGE_TAPS),
             min(K, (s + 1) * NR // splits * STEM_RANGE_TAPS))
            for s in range(splits)]


def stem_smem_bytes(K, cin, cols, splits, bf16=False,
                    warps=STEM_MAX_WARPS):
    """Shared memory of a K3 block: the weight slice of the longest tap
    range, cols columns (bf16: 8 channels a tap, an odd range's taps
    rounded up to a pair, then each warp's A tile and map tile)."""
    taps = max(ke - kb for kb, ke in stem_tap_ranges(K, splits))
    if bf16:
        return 2 * (taps + taps % 2) * MAX_CIN * cols + \
            warps * STEM_WARP_SMEM_BYTES
    return 4 * taps * cin * cols


def _stem_forward(x, idx, ok, weight):
    if not x.is_cuda:
        return stem_conv_plain(x, idx, ok, weight)
    B, N, Cin = x.shape
    K, _, Cout = weight.shape
    return stem_conv_split(x, idx, ok, weight, *stem_conv_plan(
        B, N, K, Cin, Cout, x.dtype == torch.bfloat16))


def stem_conv_split(x, idx, ok, weight, cols, warps, splits, blocks):
    """K3 on CUDA tensors with a given plan (stem_conv_plan gives
    stem_conv's); one launch count (at bf16 a padding kernel first where
    Cin < 8, and with splits > 1 the ranges' sum after). x and weight both
    fp32 or both bf16."""
    cuda_lib.check_cuda_tensor("stem_conv x", x,
                               (torch.float32, torch.bfloat16), 3)
    cuda_lib.check_cuda_tensor("stem_conv idx", idx, torch.int32, 3)
    cuda_lib.check_cuda_tensor("stem_conv ok", ok, torch.bool, 3)
    cuda_lib.check_cuda_tensor("stem_conv weight", weight, x.dtype, 3)
    B, N, Cin = x.shape
    K, wcin, Cout = weight.shape
    if tuple(idx.shape) != (B, N, K) or tuple(ok.shape) != (B, N, K) or \
            wcin != Cin or Cin > MAX_CIN or Cout % 4:
        raise ValueError(f"stem_conv: x{tuple(x.shape)} idx"
                         f"{tuple(idx.shape)} ok{tuple(ok.shape)} weight"
                         f"{tuple(weight.shape)} (Cin <= {MAX_CIN}, Cout a "
                         f"multiple of 4)")
    bf16 = x.dtype == torch.bfloat16
    if cols not in (32, 64) or not 1 <= warps <= STEM_MAX_WARPS or \
            blocks < 1 or not 1 <= splits <= len(stem_sum_ranges(K)) or \
            stem_smem_bytes(K, Cin, cols, splits, bf16, warps) > \
            STEM_MAX_SMEM:
        raise ValueError(f"stem_conv: plan ({cols} columns, {warps} warps, "
                         f"{splits} tap ranges, {blocks} blocks) for K = {K},"
                         f" Cin = {Cin}")
    pout = -Cout % 8 if bf16 else 0
    weight = _aligned(_pad_channels(weight, pout))
    out = torch.empty((B, N, Cout + pout), dtype=x.dtype, device=x.device)
    # the block ranges' fp32 partial sums, apart from the output so that
    # the activation does not keep them alive
    work = torch.empty(splits * out.numel(), dtype=torch.float32,
                       device=x.device) if splits > 1 else None
    wp = None if work is None else work.data_ptr()
    nwork = 0 if work is None else 4 * work.numel()
    if bf16:
        # x's rows padded to 8 channels (16 bytes) by the call's first
        # kernel
        x = _aligned(x) if Cin == MAX_CIN else x
        xp = torch.empty((B, N, MAX_CIN), dtype=x.dtype, device=x.device) \
            if Cin < MAX_CIN else None
        cuda_lib.launch("stem_conv_bf16", "r3dl_stem_conv_bf16",
                        x.data_ptr(), None if xp is None else xp.data_ptr(),
                        idx.data_ptr(), ok.data_ptr(), weight.data_ptr(),
                        out.data_ptr(), wp, B, N, K, Cin, Cout + pout, cols,
                        warps, splits, blocks, nwork)
        return out[..., :Cout] if pout else out
    cuda_lib.launch("stem_conv", "r3dl_stem_conv", x.data_ptr(),
                    idx.data_ptr(), ok.data_ptr(), weight.data_ptr(),
                    out.data_ptr(), wp, B, N, K, Cin, Cout, cols, warps,
                    splits, blocks, nwork)
    return out


def stem_grad_rows(g, idx, ok, weight, n):
    """K10's operands for the stem's input gradient: G = g W^T for every
    (row, tap) pair, (B, N K, Cin) in g's dtype (a bf16 G summed in fp32
    and rounded once), from one (B N, Cout) x (Cout, K Cin) matmul (459 MB
    at the policy's training shape in fp32), and the flat map with every
    dead link sent to the sentinel row n."""
    B, N, Cout = g.shape
    K, Cin, _ = weight.shape
    G = torch.matmul(g.reshape(B * N, Cout),
                     weight.reshape(K * Cin, Cout).t())
    return G.reshape(B, N * K, Cin), torch.where(ok, idx, n).reshape(
        B, N * K)


def stem_input_grad(g, idx, ok, weight, n):
    """dx of the stem conv for the output cotangent g (B, N, Cout):
    dx[b, idx[b, m, k]] += ok[b, m, k] W[k] g[b, m], K10 on
    stem_grad_rows."""
    return scatter_rows_smallc_add(*stem_grad_rows(g, idx, ok, weight, n), n)


class _StemConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, ok, weight):
        ctx.save_for_backward(x, idx, ok, weight)
        return _stem_forward(x, idx, ok, weight)

    @staticmethod
    def backward(ctx, g):
        x, idx, ok, weight = ctx.saved_tensors
        g = g.contiguous()
        dx = stem_input_grad(g, idx, ok, weight, x.shape[1]) \
            if ctx.needs_input_grad[0] else None
        dw = conv_weight_grad(x, idx, ok, g).to(weight.dtype) \
            if ctx.needs_input_grad[3] else None
        return dx, None, None, dw


def stem_conv(x, idx, ok, weight):
    """The CUDA kernel for CUDA tensors, the plain version for CPU ones;
    differentiable in the input (K10 after one matmul) and the weight (K7),
    fp32 or bf16."""
    if x.is_cuda:
        idx = idx.to(torch.int32).contiguous()
    return _StemConv.apply(x, idx, ok, weight)
