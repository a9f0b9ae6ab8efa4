"""Serialized patch attention (port of robot3dlotus_tpu/ops/pallas_attention.py):
K1 `patch_attention`, the eval forward, and K5/K6
`patch_attention_dropout`, the training forward and backward with
attention dropout inside the kernels.

Per (patch g, head h): a = softmax(where(key_valid, (q * scale) k^T, -1e9))
with fp32 logits and softmax, out = a v, in the JAX package's (G, H, P, Dh)
layout. With dropout, out = where(keep, a / (1 - rate), 0) v and keep =
bits >= rate * 2^32, the bits drawn by a Philox4x32-10 generator keyed by
(seed, g * H + h) at counter element_index // 4 (csrc/attention_dropout.cu;
philox_keep_mask below is the same generator in PyTorch).

The forward (K5, patch_attention_dropout_fwd) returns (out, lse, bits):
the row logsumexp of the masked logits, (G, H, P) fp32, and the keep mask
packed 32 keys to a word, (G, H, P, ceil(P / 32)) int32 holding the uint32
pattern (bit j % 32 of word j // 32; pack_keep_bits). The backward (K6,
patch_attention_dropout_bwd) reads them with out and the cotangent: no
logit is recomputed for statistics and no random bit is drawn again.

K1 also takes bf16 q, k and v (compute_dtype bfloat16, serving) and
computes the JAX package's XLA attention at that dtype (models/layers.py
SerializedAttention): q * scale rounded to bf16 (with scale itself a bf16
value, as a Python float meets a bf16 array in JAX), fp32 logits and
softmax, the probabilities rounded to bf16, P v summed in fp32 and the
output rounded to bf16 (patch_attention_plain does the same in PyTorch;
the kernel is r3dl_patch_attention_bf16, counted as patch_attention_bf16).
The Pallas body (pallas_attention.py) scales q after widening it to fp32
instead, so the two JAX paths differ at bf16; the port follows the XLA
path. K5 and K6 take bf16 too (training under compute_dtype bfloat16;
csrc r3dl_attention_dropout_fwd_bf16 / _bwd_bf16, counted as
patch_attention_dropout_bf16 / patch_attention_dropout_bwd_bf16). K5
rounds where K1 does, so that the training and serving forwards agree:
q * scale in bf16, fp32 logits, softmax and lse, the dropped probabilities
(p / (1 - rate) where kept) rounded to bf16 before P v, which sums in
fp32, and the output rounded once; the keep bits are the fp32 path's. K6
computes as the Pallas body `_attn_drop_bwd_kernel` does, in fp32 from the
widened inputs: p = exp(logits - lse) from the bf16 q * scale, unrounded
probabilities in dv and ds, D = g . out from K5's bf16 output, and dq, dk
and dv each rounded to bf16 once.

The CUDA kernels are csrc/attention.cu (K1) and csrc/attention_dropout.cu
(K5, K6); K1 and K5 run one forward tile per dtype (csrc/
attention_tile.cuh: 3xTF32 at fp32, bf16 mma.sync at bf16, so K5 at rate
0 is K1 bit for bit), and K1 splits each patch's query rows over blocks
by attention_query_split. At bf16 both stage k and v 16 bytes at a time
and read q in bf16 pairs: the wrappers hand them 16-byte aligned tensors
(a copy of an unaligned view).
The plain versions are the path for CPU tensors and the kernels' oracles;
patch_attention_dropout_plain and patch_attention_dropout_vjp_plain take
the keep mask as a (G, H, P, P) bool tensor.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .bf16 import bf16_value
from .conv import _aligned

NEG_INF = -1e9
KERNEL_HEAD_DIMS = (8, 16, 24, 32)
KERNEL_MAX_PATCH = 128
QUERY_ROWS = 16                    # query rows per warp (the mma's m)
ATTN_MAX_WARPS = KERNEL_MAX_PATCH // QUERY_ROWS
ATTN_TARGET_BLOCKS = 128           # about one block per SM of the H100

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def patch_attention_plain(q, k, v, key_valid, scale):
    """q/k/v: (G, H, P, Dh); key_valid: (G, P) bool -> (G, H, P, Dh)."""
    return patch_attention_dropout_plain(q, k, v, key_valid, scale, 0.0, None)


def _scaled(q, scale):
    """q * scale; for bf16 q, in bf16 as the JAX reference computes it."""
    if q.dtype == torch.bfloat16:
        return (q.float() * bf16_value(scale)).to(q.dtype)
    return q * scale


def _logits(q, k, key_valid, scale):
    logits = torch.einsum("ghpd,ghqd->ghpq", _scaled(q, scale).float(),
                          k.float())
    return torch.where(key_valid[:, None, None, :], logits,
                       torch.full_like(logits, NEG_INF))


def bf16_probability_allowance(q, k, v, key_valid, scale, rate=0.0,
                               keep=None):
    """2^-7 sum_j p_j |v_j| (G, H, P, Dh) fp32: one bf16 ulp of each
    probability's share of the output, the part of K1's (and, with the
    dropped probabilities of `rate` and `keep`, K5's) bf16 bar that a
    probability rounded to the neighbouring bf16 value can move
    (ops/bf16.py)."""
    a = _drop(torch.softmax(_logits(q, k, key_valid, scale), dim=-1), rate,
              keep)
    return torch.einsum("ghpq,ghqd->ghpd", a, v.float().abs()) * 2.0 ** -7


def _drop(t, rate, keep):
    """where(keep, t / (1 - rate), 0); keep None: keep all."""
    t = t / (1.0 - rate)
    return t if keep is None else torch.where(keep, t, torch.zeros_like(t))


def patch_attention_dropout_plain(q, k, v, key_valid, scale, rate, keep):
    """keep: (G, H, P, P) bool (None: keep all) -> (G, H, P, Dh). The
    probabilities are cast to v's dtype before the product, which sums in
    fp32."""
    a = torch.softmax(_logits(q, k, key_valid, scale), dim=-1)
    return torch.einsum("ghpq,ghqd->ghpd",
                        _drop(a, rate, keep).to(v.dtype).float(),
                        v.float()).to(q.dtype)


def patch_attention_dropout_vjp_plain(q, k, v, key_valid, scale, rate, keep,
                                      g):
    """(dq, dk, dv) of patch_attention_dropout_plain for the cotangent g
    (keep None: keep all), recomputing the probabilities: the math of the
    JAX package's `_attn_drop_bwd_kernel`, with ds zeroed at masked keys
    (the exact gradient; the two differ only in a patch with no valid
    key)."""
    a = torch.softmax(_logits(q, k, key_valid, scale), dim=-1)
    g, v, q, k = g.float(), v.float(), q.float(), k.float()
    dv = torch.einsum("ghpq,ghpd->ghqd", _drop(a, rate, keep), g)
    da = _drop(torch.einsum("ghpd,ghqd->ghpq", g, v), rate, keep)
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
    """(G, H, P, P) bool keep mask of K5 for `seed`, in PyTorch."""
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


def pack_keep_bits(keep):
    """(..., P) bool -> (..., ceil(P / 32)) int32 words holding the uint32
    pattern whose bit j % 32 of word j // 32 is keep[..., j]."""
    P = keep.shape[-1]
    W = (P + 31) // 32
    padded = torch.nn.functional.pad(keep.to(torch.int64), (0, 32 * W - P))
    shifts = torch.arange(32, dtype=torch.int64, device=keep.device)
    words = (padded.reshape(*keep.shape[:-1], W, 32) << shifts).sum(-1)
    return torch.where(words > 0x7FFFFFFF, words - (1 << 32),
                       words).to(torch.int32)


def unpack_keep_bits(bits, P):
    """pack_keep_bits' inverse: (..., W) int32 words -> (..., P) bool."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    b = ((bits.to(torch.int64) & _U32)[..., None] >> shifts) & 1
    return b.reshape(*bits.shape[:-1], -1)[..., :P].bool()


def _plain_keep(q, rate, seed):
    """The kernels' mask for CPU tensors; at rate 0 every bit passes."""
    G, H, P, _ = q.shape
    if rate == 0.0:
        return torch.ones((G, H, P, P), dtype=torch.bool, device=q.device)
    return philox_keep_mask(seed, G, H, P, rate, q.device)


def patch_attention_dropout_fwd_plain(q, k, v, key_valid, scale, rate, seed):
    """K5's plain version: (out, lse, bits) with the Philox mask of
    `seed`; at bf16 the dropped probabilities are rounded to bf16 before
    the product (the module docstring)."""
    logits = _logits(q, k, key_valid, scale)
    keep = _plain_keep(q, rate, seed)
    a = torch.softmax(logits, dim=-1)
    out = torch.einsum("ghpq,ghqd->ghpd",
                       _drop(a, rate, keep).to(v.dtype).float(), v.float())
    return (out.to(q.dtype), torch.logsumexp(logits, dim=-1),
            pack_keep_bits(keep))


def patch_attention_dropout_bwd_plain(q, k, v, key_valid, out, lse, bits, g,
                                      scale, rate):
    """K6's plain version: (dq, dk, dv), fp32, from the forward's saved
    (q, k, v, key_valid, out, lse, bits) and the cotangent g, as K6
    computes them: p = exp(logits - lse), D = g . out, ds zeroed at masked
    keys, dk = ds^T (q * scale) and dq = (ds k) * scale, with q * scale
    and scale as the forward took them (bf16 at bf16); in a patch with no
    valid key p = 1 / P (lse rounds to -1e9 there)."""
    P = q.shape[2]
    logits = _logits(q, k, key_valid, scale)
    qs = _scaled(q, scale).float()
    if q.dtype == torch.bfloat16:
        scale = bf16_value(scale)
    k, v, g, out = (t.float() for t in (k, v, g, out))
    valid = key_valid[:, None, None, :]
    p = torch.where(valid, torch.exp(logits - lse[..., None]), 0.0)
    p = torch.where(key_valid.any(-1)[:, None, None, None], p, 1.0 / P)
    keep = unpack_keep_bits(bits, P)
    dv = torch.einsum("ghpq,ghpd->ghqd", _drop(p, rate, keep), g)
    da = _drop(torch.einsum("ghpd,ghqd->ghpq", g, v), rate, keep)
    ds = p * (da - (g * out).sum(-1, keepdim=True))
    ds = torch.where(valid, ds, torch.zeros_like(ds))
    dq = torch.einsum("ghpq,ghqd->ghpd", ds, k) * scale
    dk = torch.einsum("ghpq,ghpd->ghqd", ds, qs)
    return dq, dk, dv


def _check_attention(name, q, k, v, key_valid, *more):
    """The kernels' contract: q, k, v and `more` contiguous CUDA tensors of
    one (G, H, P, Dh) shape and one dtype, fp32 or bf16, key_valid (G, P)
    bool."""
    for n, t in (("q", q), ("k", k), ("v", v),
                 *((f"arg {i}", t) for i, t in enumerate(more))):
        cuda_lib.check_cuda_tensor(
            f"{name} {n}", t,
            (q.dtype,) if n != "q" else (torch.float32, torch.bfloat16), 4)
    cuda_lib.check_cuda_tensor(f"{name} key_valid", key_valid, torch.bool, 2)
    G, H, P, Dh = q.shape
    if any(t.shape != q.shape for t in (k, v, *more)) or \
            tuple(key_valid.shape) != (G, P):
        raise ValueError(f"{name}: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"{[tuple(t.shape) for t in more]} "
                         f"key_valid{tuple(key_valid.shape)}")
    if Dh not in KERNEL_HEAD_DIMS or P > KERNEL_MAX_PATCH:
        raise ValueError(f"{name} kernel: head dim {Dh} not in "
                         f"{KERNEL_HEAD_DIMS} or patch {P} > "
                         f"{KERNEL_MAX_PATCH}")
    return G, H, P, Dh


def attention_query_split(G, H, P):
    """K1's (warps, splits): block s of patch (g, h) runs `warps` warps on
    its query rows [QUERY_ROWS warps s, QUERY_ROWS warps (s + 1)), one
    16-row group a warp, `splits` blocks a patch. The largest block that
    still launches about one block per SM (ATTN_TARGET_BLOCKS); one warp a
    block when none does. Each block loads its patch's K and V (32 KB), so
    smaller blocks than that cost more than the SMs they fill (a B = 1
    call of G H = 64: 4 warps, 128 blocks)."""
    groups = -(-P // QUERY_ROWS)
    warps = 1
    for w in (8, 4, 2):
        if w <= groups and G * H * -(-groups // w) >= ATTN_TARGET_BLOCKS:
            warps = w
            break
    return warps, -(-groups // warps)


def patch_attention(q, k, v, key_valid, scale):
    """Masked per-patch attention, q, k, v fp32 or bf16: the CUDA kernel
    (K1) for CUDA tensors, the plain version for CPU tensors. K1 has no
    backward: a CUDA call that must carry a gradient raises
    (patch_attention_dropout has one)."""
    if not q.is_cuda:
        return patch_attention_plain(q, k, v, key_valid, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        raise RuntimeError("patch_attention (K1) has no backward; use "
                           "patch_attention_dropout for a gradient")
    G, H, P, _ = q.shape
    return patch_attention_split(q, k, v, key_valid, scale,
                                 *attention_query_split(G, H, P))


def patch_attention_split(q, k, v, key_valid, scale, warps, splits):
    """K1 on CUDA tensors with a given query split (attention_query_split
    gives patch_attention's); one launch."""
    G, H, P, Dh = _check_attention("patch_attention", q, k, v, key_valid)
    if not 1 <= warps <= ATTN_MAX_WARPS or splits < 1 or \
            QUERY_ROWS * warps * splits < P:
        raise ValueError(f"patch_attention: split ({warps} warps, {splits} "
                         f"blocks) does not cover {P} query rows")
    out = torch.empty_like(q)
    k, v = _aligned(k), _aligned(v)
    if q.dtype == torch.bfloat16:
        q = _aligned(q)
        kernel, entry, scale = ("patch_attention_bf16",
                                "r3dl_patch_attention_bf16",
                                bf16_value(scale))
    else:
        kernel, entry = "patch_attention", "r3dl_patch_attention"
    cuda_lib.launch(kernel, entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    key_valid.data_ptr(), out.data_ptr(), G, H, P, Dh, warps,
                    splits, float(scale))
    return out


def _dropout_args(rate, seed):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention dropout rate {rate} not in [0, 1)")
    if not 0 <= seed < (1 << 32):
        raise ValueError(f"attention dropout seed {seed} not a uint32")
    return seed, keep_threshold(rate), 1.0 / (1.0 - rate)


def _dropout_route(q, scale, kernel, entry):
    """(counter, entry point, scale) of K5 or K6 for q's dtype: at bf16 the
    _bf16 entry and scale rounded to bf16, as K1's bf16 path takes it."""
    if q.dtype == torch.bfloat16:
        return kernel + "_bf16", entry + "_bf16", bf16_value(scale)
    return kernel, entry, float(scale)


def patch_attention_dropout_fwd(q, k, v, key_valid, scale, rate, seed):
    """(out, lse, bits) of the training attention, q, k, v fp32 or bf16
    (lse fp32): K5 for CUDA tensors, the plain version for CPU tensors."""
    seed, thresh, inv_keep = _dropout_args(rate, seed)
    if not q.is_cuda:
        return patch_attention_dropout_fwd_plain(q, k, v, key_valid, scale,
                                                 rate, seed)
    G, H, P, Dh = _check_attention("patch_attention_dropout", q, k, v,
                                   key_valid)
    if q.dtype == torch.bfloat16:
        q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = q.new_empty((G, H, P), dtype=torch.float32)
    bits = torch.empty((G, H, P, (P + 31) // 32), dtype=torch.int32,
                       device=q.device)
    kernel, entry, scale = _dropout_route(q, scale, "patch_attention_dropout",
                                          "r3dl_attention_dropout_fwd")
    cuda_lib.launch(kernel, entry,
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    key_valid.data_ptr(), out.data_ptr(), lse.data_ptr(),
                    bits.data_ptr(), G, H, P, Dh, scale, seed, thresh,
                    inv_keep)
    return out, lse, bits


def patch_attention_dropout_bwd(q, k, v, key_valid, out, lse, bits, g, scale,
                                rate):
    """(dq, dk, dv) of patch_attention_dropout for the cotangent g, from
    what the forward returned, in q's dtype: K6 for CUDA tensors, the plain
    version for CPU tensors."""
    if not q.is_cuda:
        grads = patch_attention_dropout_bwd_plain(
            q, k, v, key_valid, out, lse, bits, g, scale, rate)
        return tuple(t.to(q.dtype) for t in grads)
    G, H, P, Dh = _check_attention("patch_attention_dropout_bwd", q, k, v,
                                   key_valid, out, g)
    cuda_lib.check_cuda_tensor("patch_attention_dropout_bwd lse", lse,
                               torch.float32, 3)
    cuda_lib.check_cuda_tensor("patch_attention_dropout_bwd bits", bits,
                               torch.int32, 4)
    if tuple(lse.shape) != (G, H, P) or \
            tuple(bits.shape) != (G, H, P, (P + 31) // 32):
        raise ValueError(f"patch_attention_dropout_bwd: lse "
                         f"{tuple(lse.shape)}, bits {tuple(bits.shape)}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    kernel, entry, scale = _dropout_route(q, scale,
                                          "patch_attention_dropout_bwd",
                                          "r3dl_attention_dropout_bwd")
    cuda_lib.launch(kernel, entry, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), key_valid.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), bits.data_ptr(), g.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), G, H, P, Dh,
                    scale, 1.0 / (1.0 - rate))
    return dq, dk, dv


class _PatchAttentionDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_valid, scale, rate, seed):
        out, lse, bits = patch_attention_dropout_fwd(q, k, v, key_valid,
                                                     scale, rate, seed)
        ctx.save_for_backward(q, k, v, key_valid, out, lse, bits)
        ctx.args = (scale, rate)
        return out

    @staticmethod
    def backward(ctx, g):
        return (*patch_attention_dropout_bwd(*ctx.saved_tensors,
                                             g.contiguous(), *ctx.args),
                None, None, None, None)


def patch_attention_dropout(q, k, v, key_valid, scale, rate, seed):
    """Training attention with in-kernel dropout (K5 forward, K6 backward)
    for CUDA tensors; the plain versions with philox_keep_mask for CPU
    tensors. seed: a uint32 int, one per call (the wrapper's generator
    draws it); at rate 0 this is exact attention and its exact backward."""
    return _PatchAttentionDropout.apply(q, k, v, key_valid, float(scale),
                                        float(rate), int(seed))
