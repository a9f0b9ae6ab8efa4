"""K1, serialized patch attention (port of
robot3dlotus_tpu/ops/pallas_attention.py `patch_attention`).

Per (patch g, head h): softmax(where(key_valid, (q * scale) k^T, -1e9)) v
with fp32 logits and softmax, in the JAX package's (G, H, P, Dh) layout.
The CUDA kernel is csrc/attention.cu; patch_attention_plain is the same
function in PyTorch, the path for CPU tensors and the kernel's oracle.
"""
from __future__ import annotations

import torch

from . import cuda_lib

NEG_INF = -1e9
KERNEL_HEAD_DIMS = (8, 16, 24, 32)
KERNEL_MAX_PATCH = 128


def patch_attention_plain(q, k, v, key_valid, scale):
    """q/k/v: (G, H, P, Dh); key_valid: (G, P) bool -> (G, H, P, Dh)."""
    logits = torch.einsum("ghpd,ghqd->ghpq", (q * scale).float(), k.float())
    logits = torch.where(key_valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    a = torch.softmax(logits, dim=-1)
    return torch.einsum("ghpq,ghqd->ghpd", a.to(v.dtype), v).to(q.dtype)


def patch_attention(q, k, v, key_valid, scale):
    """Masked per-patch attention: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if not q.is_cuda:
        return patch_attention_plain(q, k, v, key_valid, scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda_lib.check_cuda_tensor(f"patch_attention {name}", t,
                                   torch.float32, 4)
    cuda_lib.check_cuda_tensor("patch_attention key_valid", key_valid,
                               torch.bool, 2)
    G, H, P, Dh = q.shape
    if k.shape != q.shape or v.shape != q.shape or \
            tuple(key_valid.shape) != (G, P):
        raise ValueError(f"patch_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"key_valid{tuple(key_valid.shape)}")
    if Dh not in KERNEL_HEAD_DIMS or P > KERNEL_MAX_PATCH:
        raise ValueError(f"patch_attention kernel: head dim {Dh} not in "
                         f"{KERNEL_HEAD_DIMS} or patch {P} > "
                         f"{KERNEL_MAX_PATCH}")
    out = torch.empty_like(q)
    cuda_lib.launch("patch_attention", "r3dl_patch_attention", q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
                    out.data_ptr(), G, H, P, Dh, float(scale))
    return out
