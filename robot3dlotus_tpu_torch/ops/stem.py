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
few to fill the card, so its tap chunks are split into ranges that a
second kernel adds in a fixed order (two launches for one count).

bf16 (compute_dtype bfloat16, serving): x and W bf16, the taps summed in
fp32 and the output rounded to bf16 once (csrc r3dl_stem_conv_bf16,
counted as stem_conv_bf16; the tap ranges' partials stay fp32). The
backward takes fp32 only.

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
from .conv import _aligned, conv_weight_grad
from .gather import scatter_rows_smallc_add

MAX_CIN = 8
STEM_TAPS_PER_CHUNK = 8          # csrc/stem.cu kKT
STEM_ROWS_PER_WARP = 16          # the mma's m
STEM_MAX_WARPS = 16              # csrc/stem.cu kMaxWarps
STEM_MAX_SMEM = 227 * 1024       # shared memory an H100 block may hold
STEM_SMS = 132                   # the H100's SMs
STEM_TARGET_BLOCKS = 128         # about one block per SM


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


def stem_conv_plan(B, N, K, cin, cout):
    """K3's (cols, warps, splits, blocks). A block owns `cols` output
    channels (64; 32 at Cin = 8, where 64 columns of 125 taps' weight
    would not fit its shared memory) and tap range s of `splits`
    (stem_tap_ranges); its `warps` warps take the B N rows (flat over the
    clouds) in 16-row groups, group blockIdx.x warps + warp + i blocks
    warps. Blocks are 16 warps (the weight slice is staged once per 256
    rows). Where every warp of one block per SM then gets two groups or
    more (a training batch), that: each SM loads the weight once. Else
    one group a warp, and the tap chunks split into enough ranges for
    about one block per SM (STEM_TARGET_BLOCKS; a B = 1 cloud: 8 ranges
    of 2 chunks)."""
    cols = 64 if cin <= 7 else 32
    col_tiles = -(-cout // cols)
    groups = -(-B * N // STEM_ROWS_PER_WARP)
    chunks = -(-K // STEM_TAPS_PER_CHUNK)
    warps = min(STEM_MAX_WARPS, groups)
    blocks = -(-groups // warps)
    per_sm = -(-STEM_SMS // col_tiles)
    if blocks >= 2 * per_sm:
        return cols, warps, 1, per_sm
    splits = max(1, min(chunks, -(-STEM_TARGET_BLOCKS //
                                   (blocks * col_tiles))))
    return cols, warps, splits, blocks


def stem_tap_ranges(K, splits):
    """[(k_begin, k_end)] per tap range: range s holds the 8-tap chunks
    [s C // splits, (s + 1) C // splits) of C = ceil(K / 8), as csrc/stem.cu
    splits them."""
    C = -(-K // STEM_TAPS_PER_CHUNK)
    return [(min(K, s * C // splits * STEM_TAPS_PER_CHUNK),
             min(K, (s + 1) * C // splits * STEM_TAPS_PER_CHUNK))
            for s in range(splits)]


def stem_smem_bytes(K, cin, cols, splits):
    """Shared memory of a K3 block: the weight slice of the longest tap
    range, cols columns."""
    taps = max(ke - kb for kb, ke in stem_tap_ranges(K, splits))
    return 4 * taps * cin * cols


def _stem_forward(x, idx, ok, weight):
    if not x.is_cuda:
        return stem_conv_plain(x, idx, ok, weight)
    B, N, Cin = x.shape
    K, _, Cout = weight.shape
    return stem_conv_split(x, idx, ok, weight,
                           *stem_conv_plan(B, N, K, Cin, Cout))


def stem_conv_split(x, idx, ok, weight, cols, warps, splits, blocks):
    """K3 on CUDA tensors with a given plan (stem_conv_plan gives
    stem_conv's); one launch count. x and weight both fp32 or both
    bf16."""
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
    if cols not in (32, 64) or not 1 <= warps <= STEM_MAX_WARPS or \
            blocks < 1 or not 1 <= splits <= -(-K // STEM_TAPS_PER_CHUNK) or \
            stem_smem_bytes(K, Cin, cols, splits) > STEM_MAX_SMEM:
        raise ValueError(f"stem_conv: plan ({cols} columns, {warps} warps, "
                         f"{splits} tap ranges, {blocks} blocks) for K = {K},"
                         f" Cin = {Cin}")
    out = torch.empty((B, N, Cout), dtype=x.dtype, device=x.device)
    # the tap ranges' fp32 partial sums, apart from the output so that the
    # activation does not keep them alive
    work = torch.empty(splits * out.numel(), dtype=torch.float32,
                       device=x.device) if splits > 1 else None
    weight = _aligned(weight)
    kernel, entry = ("stem_conv_bf16", "r3dl_stem_conv_bf16") \
        if x.dtype == torch.bfloat16 else ("stem_conv", "r3dl_stem_conv")
    cuda_lib.launch(kernel, entry, x.data_ptr(),
                    idx.data_ptr(), ok.data_ptr(), weight.data_ptr(),
                    out.data_ptr(),
                    None if work is None else work.data_ptr(), B, N, K, Cin,
                    Cout, cols, warps, splits, blocks,
                    0 if work is None else 4 * work.numel())
    return out


def stem_grad_rows(g, idx, ok, weight, n):
    """K10's operands for the stem's input gradient: G = g W^T for every
    (row, tap) pair, (B, N K, Cin), from one (B N, Cout) x (Cout, K Cin)
    matmul (459 MB at the policy's training shape), and the flat map with
    every dead link sent to the sentinel row n."""
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
        if x.dtype != torch.float32:
            raise NotImplementedError(
                f"stem_conv backward: K7 and K10 take fp32 only, got "
                f"{x.dtype}")
        g = g.contiguous()
        dx = stem_input_grad(g, idx, ok, weight, x.shape[1]) \
            if ctx.needs_input_grad[0] else None
        dw = conv_weight_grad(x, idx, ok, g) \
            if ctx.needs_input_grad[3] else None
        return dx, None, None, dw


def stem_conv(x, idx, ok, weight):
    """The CUDA kernel for CUDA tensors, the plain version for CPU ones;
    differentiable in the input (K10 after one matmul) and the weight
    (K7)."""
    if x.is_cuda:
        idx = idx.to(torch.int32).contiguous()
    return _StemConv.apply(x, idx, ok, weight)
