"""K2, submanifold sparse conv on a (B, N, K) neighbour map, and K7, its
weight gradient (port of robot3dlotus_tpu/ops/pallas_conv.py
`subm_conv_windowed` and its custom VJP `_windowed_op`).

out[b, n] = sum_k ok[b, n, k] * W[k]^T x[b, idx[b, n, k]] + bias, with W
(K, Cin, Cout) in stencil_offsets order. The CUDA kernels are csrc/conv.cu
(K2) and csrc/conv_grad.cu (K7); both read the map directly: no
WindowMap, no halo, no far lists, and multiply only the live links, on the
tensor cores as 3xTF32 (the sources say how). subm_conv_plain and
conv_weight_grad_plain are the same functions in PyTorch, the path for CPU
tensors and the kernels' oracles. A CUDA call of either wrapper is one
launch count and one ctypes call, which launches one to three kernels: K2
adds a fixed-order reduction of its tap ranges when B N is too small to
fill the card (conv_tap_splits), K7 a compaction of each tap's live rows
and, with more than one row range, a fixed-order sum of the ranges
(weight_grad_plan).

Backward: dW is K7, dbias a plain sum, and dx is the conv itself run on
a cotangent with the mirrored weight W'[k] = W[K-1-k]^T (K2 again), as in
the JAX package. The mirrored conv alone is the adjoint only of a
link-symmetric map (stencil_offsets(K-1-k) == -stencil_offsets(k) holds),
and rotated, augmented clouds put several points into one voxel: the map
points every lookup at the voxel's lowest index (its owner), so the other
points have links out and none in. conv_input_grad makes dx exact for any
map: K8 first adds each valid row's cotangent onto its voxel's owner (the
centre tap's index), the mirrored K2 runs on those sums, and rows that own
no voxel get 0. (The JAX package's windowed path runs the mirrored conv on
the raw cotangent, which is exact only without duplicates:
pallas_conv.py `subm_conv_windowed` docstring.)
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .gather import scatter_rows_add

CONV_ROWS = 128          # csrc/conv.cu kTM: output rows per block
CONV_COLS = 64           # csrc/conv.cu kTN: output channels per block
CONV_MAX_TAPS = 27       # csrc/conv.cu kMaxK
CONV_TARGET_BLOCKS = 132 * 2    # two 109 KB blocks on each of 132 SMs
WGRAD_TILE = 64          # csrc/conv_grad.cu kT: dW tile side
WGRAD_TARGET_BLOCKS = 132 * 3   # three 73 KB blocks on each of 132 SMs
WGRAD_MIN_ROWS = 512


def subm_conv_plain(x, idx, ok, weight, bias=None):
    """x (B, N, Cin); idx/ok (B, N, K); weight (K, Cin, Cout)."""
    B, N, _ = x.shape
    out = x.new_zeros((B, N, weight.shape[-1]))
    for k in range(weight.shape[0]):
        g = torch.gather(x, 1, idx[..., k].long()[..., None].expand(
            -1, -1, x.shape[-1]))
        g = torch.where(ok[..., k, None], g, torch.zeros_like(g))
        out = out + g @ weight[k]
    if bias is not None:
        out = out + bias
    return out


def conv_weight_grad_plain(x, idx, ok, g):
    """dW (K, Cin, Cout) = sum_{b,n} ok[b,n,k] x[b, idx[b,n,k]]^T g[b,n]."""
    out = []
    for k in range(idx.shape[-1]):
        xs = torch.gather(x, 1, idx[..., k].long()[..., None].expand(
            -1, -1, x.shape[-1]))
        xs = torch.where(ok[..., k, None], xs, torch.zeros_like(xs))
        out.append(torch.einsum("bnc,bnd->cd", xs, g))
    return torch.stack(out)


def mirror_weight(weight):
    """W'[k] = W[K-1-k]^T: the adjoint stencil of a link-symmetric map."""
    return weight.flip(0).transpose(1, 2).contiguous()


def _check_map(name, x, idx, ok, K):
    cuda_lib.check_cuda_tensor(f"{name} x", x, torch.float32, 3)
    cuda_lib.check_cuda_tensor(f"{name} idx", idx, torch.int32, 3)
    cuda_lib.check_cuda_tensor(f"{name} ok", ok, torch.bool, 3)
    B, N, _ = x.shape
    if tuple(idx.shape) != (B, N, K) or tuple(ok.shape) != (B, N, K):
        raise ValueError(f"{name}: x{tuple(x.shape)} idx{tuple(idx.shape)} "
                         f"ok{tuple(ok.shape)} K={K}")


def _aligned(t):
    """t, or a copy of it when its data is not 16-byte aligned (the
    kernels' cp.async reads 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def conv_tap_splits(B, N, K, cout):
    """K2's tap ranges per (row tile, channel tile, cloud): one when those
    tiles fill the card, else enough (at most K) that two blocks sit on
    each SM. B = 1 at the deep stages is the case that splits. csrc/conv.cu
    gives range s the taps [s K / splits, (s + 1) K / splits)."""
    blocks = -(-N // CONV_ROWS) * -(-cout // CONV_COLS) * B
    return max(1, min(K, -(-CONV_TARGET_BLOCKS // max(blocks, 1))))


def _conv_forward(x, idx, ok, weight, bias):
    if not x.is_cuda:
        return subm_conv_plain(x, idx, ok, weight, bias)
    cuda_lib.check_cuda_tensor("subm_conv weight", weight, torch.float32, 3)
    K, wcin, Cout = weight.shape
    _check_map("subm_conv", x, idx, ok, K)
    B, N, Cin = x.shape
    if wcin != Cin or Cin % 4 or Cout % 4 or K > CONV_MAX_TAPS:
        raise ValueError(f"subm_conv: x{tuple(x.shape)} weight"
                         f"{tuple(weight.shape)} (the kernel takes channel "
                         f"counts that are multiples of 4 and at most "
                         f"{CONV_MAX_TAPS} taps)")
    bias_ptr = None
    if bias is not None:
        cuda_lib.check_cuda_tensor("subm_conv bias", bias, torch.float32, 1)
        if bias.shape[0] != Cout:
            raise ValueError(f"subm_conv: bias {tuple(bias.shape)}")
        bias_ptr = bias.data_ptr()
    splits = conv_tap_splits(B, N, K, Cout)
    out = torch.empty((B, N, Cout), dtype=x.dtype, device=x.device)
    # the tap ranges' partial sums, apart from the output so that the
    # activation does not keep them alive
    work = torch.empty(splits * out.numel(), dtype=x.dtype,
                       device=x.device) if splits > 1 else None
    x, weight = _aligned(x), _aligned(weight)
    cuda_lib.launch("subm_conv", "r3dl_subm_conv", x.data_ptr(),
                    idx.data_ptr(), ok.data_ptr(), weight.data_ptr(),
                    bias_ptr, out.data_ptr(),
                    None if work is None else work.data_ptr(), B, N, K,
                    Cin, Cout, splits, 0 if work is None else 4 * work.numel())
    return out


def weight_grad_plan(B, N, K, cin, cout):
    """(splits, rows_per_split, work_bytes) of K7: the row ranges make
    (tiles x ranges) fill the card, at least WGRAD_MIN_ROWS rows each; the
    scratch holds the live lists of the CPE path (channel counts multiples
    of 4: 2 K B N + K splits int32, rounded up to 16 bytes) and, with more
    than one range, the partial dW (splits, K, Cin, Cout) fp32, as
    csrc/conv_grad.cu lays them out."""
    rows = max(B * N, 1)
    compacted = cin % 4 == 0 and cout % 4 == 0
    otiles = -(-cout // WGRAD_TILE)
    tiles = (K * -(-cin // WGRAD_TILE) if compacted
             else -(-K * cin // WGRAD_TILE)) * otiles
    splits = max(1, min(-(-WGRAD_TARGET_BLOCKS // tiles),
                        -(-rows // WGRAD_MIN_ROWS)))
    per = -(-rows // splits)
    splits = -(-rows // per)
    lists = -(-4 * (2 * K * B * N + K * splits) // 16) * 16 if compacted \
        else 0
    return splits, per, lists + (4 * splits * K * cin * cout
                                 if splits > 1 else 0)


def conv_weight_grad(x, idx, ok, g):
    """K7 for CUDA tensors, the plain version for CPU tensors. x (B, N,
    Cin), idx/ok (B, N, K), g (B, N, Cout) -> dW (K, Cin, Cout) fp32."""
    if not x.is_cuda:
        return conv_weight_grad_plain(x, idx, ok, g)
    idx = idx.to(torch.int32).contiguous()
    K = idx.shape[-1]
    _check_map("conv_weight_grad", x, idx, ok, K)
    cuda_lib.check_cuda_tensor("conv_weight_grad g", g, torch.float32, 3)
    B, N, Cin = x.shape
    if tuple(g.shape[:2]) != (B, N):
        raise ValueError(f"conv_weight_grad: g{tuple(g.shape)} for "
                         f"x{tuple(x.shape)}")
    Cout = g.shape[-1]
    splits, per, nbytes = weight_grad_plan(B, N, K, Cin, Cout)
    dw = torch.empty((K, Cin, Cout), dtype=torch.float32, device=x.device)
    work = torch.empty(nbytes, dtype=torch.uint8, device=x.device) \
        if nbytes else None
    x, g = _aligned(x), _aligned(g)
    cuda_lib.launch("conv_weight_grad", "r3dl_conv_weight_grad",
                    x.data_ptr(), idx.data_ptr(), ok.data_ptr(), g.data_ptr(),
                    None if work is None else work.data_ptr(),
                    dw.data_ptr(), B, N, K, Cin, Cout, splits, per, nbytes)
    return dw


def conv_input_grad(g, idx, ok, weight):
    """Exact dx of subm_conv for the cotangent g (B, N, Cout): K8 gathers
    each voxel's cotangents onto its owner, K2 runs the mirrored weight on
    them, non-owner rows get 0 (see the module docstring)."""
    B, N, _ = g.shape
    centre = idx.shape[-1] // 2
    owner, valid = idx[..., centre], ok[..., centre]
    gsum = scatter_rows_add(
        torch.where(valid[..., None], g, torch.zeros_like(g)).contiguous(),
        owner, N)
    dx = _conv_forward(gsum, idx, ok, mirror_weight(weight), None)
    rows = torch.arange(N, device=g.device)[None]
    own = valid & (owner.long() == rows)
    return torch.where(own[..., None], dx, torch.zeros_like(dx))


class _SubmConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, ok, weight, bias):
        ctx.save_for_backward(x, idx, ok, weight)
        ctx.has_bias = bias is not None
        return _conv_forward(x, idx, ok, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, idx, ok, weight = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv_input_grad(g, idx, ok, weight)
        if ctx.needs_input_grad[3]:
            dw = conv_weight_grad(x, idx, ok, g)
        if ctx.has_bias and ctx.needs_input_grad[4]:
            db = g.sum((0, 1))
        return dx, None, None, dw, db


def subm_conv(x, idx, ok, weight, bias=None):
    """The CUDA kernel for CUDA tensors, the plain version for CPU ones;
    differentiable in x, weight and bias (see the module docstring)."""
    if x.is_cuda:
        idx = idx.to(torch.int32).contiguous()
        x = x.contiguous()
    return _SubmConv.apply(x, idx, ok, weight, bias)
