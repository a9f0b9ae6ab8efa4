"""K3, the fused k=5 stem conv (port of robot3dlotus_tpu/ops/pallas_stem.py
`stem_gather_windowed` plus the stencil einsum that followed it,
ops/sparse_conv.py:298).

out[b, n] = sum_k ok[b, n, k] * W[k]^T x[b, idx[b, n, k]] for Cin <= 8 and
no bias (BN and GELU follow in the model). The CUDA kernel is csrc/stem.cu
and gathers and multiplies in one pass; stem_conv_plain is the same
function in PyTorch (the gather-then-einsum form), the path for CPU tensors
and the kernel's oracle.
"""
from __future__ import annotations

import torch

from . import cuda_lib

MAX_CIN = 8


def stem_conv_plain(x, idx, ok, weight):
    """x (B, N, Cin); idx/ok (B, N, K); weight (K, Cin, Cout)."""
    B, N, C = x.shape
    K = idx.shape[-1]
    g = torch.gather(x, 1, idx.reshape(B, N * K).long()[..., None].expand(
        -1, -1, C)).reshape(B, N, K, C)
    g = torch.where(ok[..., None], g, torch.zeros_like(g))
    return torch.einsum("bnkc,kcd->bnd", g, weight)


def stem_conv(x, idx, ok, weight):
    """The CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    if not x.is_cuda:
        return stem_conv_plain(x, idx, ok, weight)
    idx = idx.to(torch.int32).contiguous()
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
