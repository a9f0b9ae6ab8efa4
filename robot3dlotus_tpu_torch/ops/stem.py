"""K3, the fused k=5 stem conv (port of robot3dlotus_tpu/ops/pallas_stem.py
`stem_gather_windowed` plus the stencil einsum that followed it,
ops/sparse_conv.py:298), and its weight gradient.

out[b, n] = sum_k ok[b, n, k] * W[k]^T x[b, idx[b, n, k]] for Cin <= 8 and
no bias (BN and GELU follow in the model). The CUDA kernel is csrc/stem.cu
and gathers and multiplies in one pass; stem_conv_plain is the same
function in PyTorch (the gather-then-einsum form), the path for CPU tensors
and the kernel's oracle.

Backward: dW is K7 (ops/conv.py conv_weight_grad) at the stem's shape. The
stem input of the policy is data and needs no gradient; the JAX package's
input-gradient kernel (`_windowed_gather_bwd`) serves only the motion
planner's label embeddings and is not ported, so an input that requires a
gradient raises.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .conv import conv_weight_grad

MAX_CIN = 8


def stem_conv_plain(x, idx, ok, weight):
    """x (B, N, Cin); idx/ok (B, N, K); weight (K, Cin, Cout)."""
    B, N, C = x.shape
    K = idx.shape[-1]
    g = torch.gather(x, 1, idx.reshape(B, N * K).long()[..., None].expand(
        -1, -1, C)).reshape(B, N, K, C)
    g = torch.where(ok[..., None], g, torch.zeros_like(g))
    return torch.einsum("bnkc,kcd->bnd", g, weight)


def _stem_forward(x, idx, ok, weight):
    if not x.is_cuda:
        return stem_conv_plain(x, idx, ok, weight)
    cuda_lib.check_cuda_tensor("stem_conv x", x, torch.float32, 3)
    cuda_lib.check_cuda_tensor("stem_conv idx", idx, torch.int32, 3)
    cuda_lib.check_cuda_tensor("stem_conv ok", ok, torch.bool, 3)
    cuda_lib.check_cuda_tensor("stem_conv weight", weight, torch.float32, 3)
    B, N, Cin = x.shape
    K, wcin, Cout = weight.shape
    if tuple(idx.shape) != (B, N, K) or tuple(ok.shape) != (B, N, K) or \
            wcin != Cin or Cin > MAX_CIN:
        raise ValueError(f"stem_conv: x{tuple(x.shape)} idx"
                         f"{tuple(idx.shape)} ok{tuple(ok.shape)} weight"
                         f"{tuple(weight.shape)} (Cin <= {MAX_CIN})")
    out = torch.empty((B, N, Cout), dtype=x.dtype, device=x.device)
    cuda_lib.launch("stem_conv", "r3dl_stem_conv", x.data_ptr(),
                    idx.data_ptr(), ok.data_ptr(), weight.data_ptr(),
                    out.data_ptr(), B, N, K, Cin, Cout)
    return out


class _StemConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, ok, weight):
        ctx.save_for_backward(x, idx, ok)
        return _stem_forward(x, idx, ok, weight)

    @staticmethod
    def backward(ctx, g):
        x, idx, ok = ctx.saved_tensors
        dw = conv_weight_grad(x, idx, ok, g.contiguous()) \
            if ctx.needs_input_grad[3] else None
        return None, None, None, dw


def stem_conv(x, idx, ok, weight):
    """The CUDA kernel for CUDA tensors, the plain version for CPU ones;
    differentiable in the weight only."""
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "stem_conv: the gradient with respect to the stem input is not "
            "ported (the policy's stem input is data)")
    if x.is_cuda:
        idx = idx.to(torch.int32).contiguous()
    return _StemConv.apply(x, idx, ok, weight)
