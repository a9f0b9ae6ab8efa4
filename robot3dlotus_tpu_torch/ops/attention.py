"""Serialized patch attention (port of robot3dlotus_tpu/ops/pallas_attention.py):
K1 `patch_attention`, the eval forward, and K5/K6
`patch_attention_dropout`, the training forward and backward with
attention dropout inside the kernels.

Per (patch g, head h): a = softmax(where(key_valid, (q * scale) k^T, -1e9))
with fp32 logits and softmax, out = a v, in the JAX package's (G, H, P, Dh)
layout. With dropout, out = where(keep, a / (1 - rate), 0) v and keep =
bits >= rate * 2^32, the bits drawn by a Philox4x32-10 generator keyed by
(seed, g * H + h) at counter element_index // 4 (csrc/attention_dropout.cu;
philox_keep_mask below is the same generator in PyTorch). The backward
regenerates the probabilities and the mask; no (G, H, P, P) tensor is kept.

The CUDA kernels are csrc/attention.cu (K1) and csrc/attention_dropout.cu
(K5, K6, and attention_dropout_mask, which writes K5's mask out). The
plain versions take the keep mask explicitly; they are the path for CPU
tensors and the kernels' oracles.
"""
from __future__ import annotations

import torch

from . import cuda_lib

NEG_INF = -1e9
KERNEL_HEAD_DIMS = (8, 16, 24, 32)
KERNEL_MAX_PATCH = 128

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def patch_attention_plain(q, k, v, key_valid, scale):
    """q/k/v: (G, H, P, Dh); key_valid: (G, P) bool -> (G, H, P, Dh)."""
    return patch_attention_dropout_plain(q, k, v, key_valid, scale, 0.0, None)


def _probs(q, k, key_valid, scale):
    logits = torch.einsum("ghpd,ghqd->ghpq", (q * scale).float(), k.float())
    logits = torch.where(key_valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    return torch.softmax(logits, dim=-1)


def patch_attention_dropout_plain(q, k, v, key_valid, scale, rate, keep):
    """keep: (G, H, P, P) bool (None: keep all) -> (G, H, P, Dh)."""
    a = _probs(q, k, key_valid, scale)
    if keep is not None:
        a = torch.where(keep, a / (1.0 - rate), torch.zeros_like(a))
    return torch.einsum("ghpq,ghqd->ghpd", a.to(v.dtype), v).to(q.dtype)


def patch_attention_dropout_bwd_plain(q, k, v, key_valid, scale, rate, keep,
                                      g):
    """(dq, dk, dv) of patch_attention_dropout_plain for the cotangent g
    (keep None: keep all): the math of the JAX package's
    `_attn_drop_bwd_kernel`, with ds zeroed at masked keys (the exact
    gradient; the two differ only in a patch with no valid key)."""
    a = _probs(q, k, key_valid, scale)
    inv_keep = 1.0 / (1.0 - rate)

    def drop(t):
        t = t * inv_keep
        return t if keep is None else torch.where(keep, t,
                                                  torch.zeros_like(t))
    ad = drop(a)
    g, v, q, k = g.float(), v.float(), q.float(), k.float()
    dv = torch.einsum("ghpq,ghpd->ghqd", ad, g)
    dad = torch.einsum("ghpd,ghqd->ghpq", g, v)
    da = drop(dad)
    ds = a * (da - (da * a).sum(-1, keepdim=True))
    # a masked key's logit is a constant: no gradient flows through it
    ds = torch.where(key_valid[:, None, None, :], ds, torch.zeros_like(ds))
    dq = torch.einsum("ghpq,ghqd->ghpd", ds, k) * scale
    dk = torch.einsum("ghpq,ghpd->ghqd", ds, q) * scale
    return dq, dk, dv


def _mulhilo(m, b):
    """High and low 32 bits of m * b for a 32-bit constant m and an int64
    tensor b in [0, 2^32), in 16-bit halves so nothing overflows int64."""
    x = m * (b & 0xFFFF)
    y = m * (b >> 16)
    mid = ((y & 0xFFFF) << 16) + x
    return (y >> 16) + (mid >> 32), mid & _U32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 values (the
    generator of csrc/attention_dropout.cu)."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _U32
        k1 = (k1 + _PHILOX_W[1]) & _U32
    return c0, c1, c2, c3


def keep_threshold(rate):
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def philox_keep_mask(seed, G, H, P, rate, device="cpu"):
    """(G, H, P, P) bool keep mask of K5/K6 for `seed`, in PyTorch."""
    e = torch.arange(P * P, dtype=torch.int64, device=device)
    c = (e >> 2)[None]
    stream = torch.arange(G * H, dtype=torch.int64, device=device)[:, None]
    zero = torch.zeros_like(c)
    words = torch.stack(philox4x32_10(c, zero, zero, zero,
                                      torch.full_like(stream, seed), stream),
                        -1).expand(G * H, P * P, 4)
    bits = torch.gather(words, -1, (e & 3)[None, :, None].expand(
        G * H, P * P, 1))[..., 0]
    return (bits >= keep_threshold(rate)).reshape(G, H, P, P)


def _check_attention(name, q, k, v, key_valid, g=None):
    for n, t in (("q", q), ("k", k), ("v", v), ("g", g)):
        if t is not None:
            cuda_lib.check_cuda_tensor(f"{name} {n}", t, torch.float32, 4)
    cuda_lib.check_cuda_tensor(f"{name} key_valid", key_valid, torch.bool, 2)
    G, H, P, Dh = q.shape
    if k.shape != q.shape or v.shape != q.shape or \
            (g is not None and g.shape != q.shape) or \
            tuple(key_valid.shape) != (G, P):
        raise ValueError(f"{name}: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"key_valid{tuple(key_valid.shape)}")
    if Dh not in KERNEL_HEAD_DIMS or P > KERNEL_MAX_PATCH:
        raise ValueError(f"{name} kernel: head dim {Dh} not in "
                         f"{KERNEL_HEAD_DIMS} or patch {P} > "
                         f"{KERNEL_MAX_PATCH}")
    return G, H, P, Dh


def patch_attention(q, k, v, key_valid, scale):
    """Masked per-patch attention: the CUDA kernel (K1) for CUDA tensors,
    the plain version for CPU tensors. K1 has no backward: a CUDA call that
    must carry a gradient raises (patch_attention_dropout has one)."""
    if not q.is_cuda:
        return patch_attention_plain(q, k, v, key_valid, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        raise RuntimeError("patch_attention (K1) has no backward; use "
                           "patch_attention_dropout for a gradient")
    G, H, P, Dh = _check_attention("patch_attention", q, k, v, key_valid)
    out = torch.empty_like(q)
    cuda_lib.launch("patch_attention", "r3dl_patch_attention", q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
                    out.data_ptr(), G, H, P, Dh, float(scale))
    return out


def attention_dropout_mask(seed, G, H, P, rate, device):
    """The keep mask K5 and K6 use for these arguments, (G, H, P, P) bool:
    written by the kernel on a CUDA device, by philox_keep_mask on the
    CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return philox_keep_mask(seed, G, H, P, rate, device)
    if not 0 < P <= KERNEL_MAX_PATCH:
        raise ValueError(f"attention_dropout_mask: patch {P}")
    keep = torch.empty((G, H, P, P), dtype=torch.uint8, device=device)
    cuda_lib.launch("attention_dropout_mask", "r3dl_attention_dropout_mask",
                    keep.data_ptr(), G, H, P, seed, keep_threshold(rate))
    return keep.bool()


def _dropout_args(rate, seed):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention dropout rate {rate} not in [0, 1)")
    if not 0 <= seed < (1 << 32):
        raise ValueError(f"attention dropout seed {seed} not a uint32")
    return seed, keep_threshold(rate), 1.0 / (1.0 - rate)


def _plain_keep(q, rate, seed):
    """The kernels' mask for CPU tensors; at rate 0 every bit passes."""
    if rate == 0.0:
        return None
    G, H, P, _ = q.shape
    return philox_keep_mask(seed, G, H, P, rate, q.device)


def _dropout_forward(q, k, v, key_valid, scale, rate, seed):
    if not q.is_cuda:
        return patch_attention_dropout_plain(q, k, v, key_valid, scale, rate,
                                             _plain_keep(q, rate, seed))
    G, H, P, Dh = _check_attention("patch_attention_dropout", q, k, v,
                                   key_valid)
    seed, thresh, inv_keep = _dropout_args(rate, seed)
    out = torch.empty_like(q)
    cuda_lib.launch("patch_attention_dropout", "r3dl_attention_dropout_fwd",
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    key_valid.data_ptr(), out.data_ptr(), G, H, P, Dh,
                    float(scale), seed, thresh, inv_keep)
    return out


def patch_attention_dropout_bwd(q, k, v, key_valid, g, scale, rate, seed):
    """(dq, dk, dv) of patch_attention_dropout for the cotangent g: K6 for
    CUDA tensors (probabilities and mask regenerated from the seed), the
    plain version with philox_keep_mask for CPU tensors."""
    if not q.is_cuda:
        grads = patch_attention_dropout_bwd_plain(
            q, k, v, key_valid, scale, rate, _plain_keep(q, rate, seed), g)
        return tuple(t.to(q.dtype) for t in grads)
    G, H, P, Dh = _check_attention("patch_attention_dropout_bwd", q, k, v,
                                   key_valid, g)
    seed, thresh, inv_keep = _dropout_args(rate, seed)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    cuda_lib.launch("patch_attention_dropout_bwd",
                    "r3dl_attention_dropout_bwd", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), key_valid.data_ptr(), g.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), G, H, P, Dh,
                    float(scale), seed, thresh, inv_keep)
    return dq, dk, dv


class _PatchAttentionDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_valid, scale, rate, seed):
        ctx.save_for_backward(q, k, v, key_valid)
        ctx.args = (scale, rate, seed)
        return _dropout_forward(q, k, v, key_valid, scale, rate, seed)

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_valid = ctx.saved_tensors
        scale, rate, seed = ctx.args
        return (*patch_attention_dropout_bwd(q, k, v, key_valid,
                                             g.contiguous(), scale, rate,
                                             seed), None, None, None, None)


def patch_attention_dropout(q, k, v, key_valid, scale, rate, seed):
    """Training attention with in-kernel dropout (K5 forward, K6 backward)
    for CUDA tensors; the plain versions with philox_keep_mask for CPU
    tensors. seed: a uint32 int, one per call (the wrapper's generator
    draws it); at rate 0 this is exact attention and its exact backward."""
    return _PatchAttentionDropout.apply(q, k, v, key_valid, float(scale),
                                        float(rate), int(seed))
