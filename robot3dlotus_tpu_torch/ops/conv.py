"""K2, submanifold sparse conv on a (B, N, K) neighbour map (port of
robot3dlotus_tpu/ops/pallas_conv.py `subm_conv_windowed`).

out[b, n] = sum_k ok[b, n, k] * W[k]^T x[b, idx[b, n, k]] + bias, with W
(K, Cin, Cout) in stencil_offsets order. The CUDA kernel is csrc/conv.cu and
reads the map directly: no WindowMap, no halo, no far lists.
subm_conv_plain is the same function in PyTorch (the JAX package's
streaming XLA form), the path for CPU tensors and the kernel's oracle.
"""
from __future__ import annotations

import torch

from . import cuda_lib


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


def subm_conv(x, idx, ok, weight, bias=None):
    """The CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    if not x.is_cuda:
        return subm_conv_plain(x, idx, ok, weight, bias)
    idx = idx.to(torch.int32).contiguous()
    cuda_lib.check_cuda_tensor("subm_conv x", x, torch.float32, 3)
    cuda_lib.check_cuda_tensor("subm_conv idx", idx, torch.int32, 3)
    cuda_lib.check_cuda_tensor("subm_conv ok", ok, torch.bool, 3)
    cuda_lib.check_cuda_tensor("subm_conv weight", weight, torch.float32, 3)
    B, N, Cin = x.shape
    K, wcin, Cout = weight.shape
    if tuple(idx.shape) != (B, N, K) or tuple(ok.shape) != (B, N, K) or \
            wcin != Cin:
        raise ValueError(f"subm_conv: x{tuple(x.shape)} idx"
                         f"{tuple(idx.shape)} ok{tuple(ok.shape)} weight"
                         f"{tuple(weight.shape)}")
    bias_ptr = None
    if bias is not None:
        cuda_lib.check_cuda_tensor("subm_conv bias", bias, torch.float32, 1)
        if bias.shape[0] != Cout:
            raise ValueError(f"subm_conv: bias {tuple(bias.shape)}")
        bias_ptr = bias.data_ptr()
    out = torch.empty((B, N, Cout), dtype=x.dtype, device=x.device)
    cuda_lib.launch("subm_conv", "r3dl_subm_conv", x.data_ptr(),
                    idx.data_ptr(), ok.data_ptr(), weight.data_ptr(),
                    bias_ptr, out.data_ptr(), B, N, K, Cin, Cout)
    return out
