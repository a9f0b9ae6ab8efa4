"""Serialized patch attention (port of robot3dlotus_tpu/ops/pallas_attention.py):
K1 `patch_attention`, the eval forward, and K5/K6
`patch_attention_dropout`, the training forward and backward with
attention dropout inside the kernels.

Per (patch g, head h): a = softmax(where(key_valid, (q * scale) k^T, -1e9))
with fp32 logits and softmax, out = a v, in the JAX package's (G, H, P, Dh)
layout. With dropout, out = where(keep, a / (1 - rate), 0) v and keep =
bits >= rate * 2^32, the bits drawn by a Philox4x32-10 generator keyed by
(seed, g * H + h) at counter element_index // 4 (csrc/attention_dropout.cuh;
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
bf16 inputs: p = exp(logits - lse) from the bf16 q * scale, unrounded
probabilities in dv and ds, D = g . out from K5's bf16 output, and dq, dk
and dv each rounded to bf16 once (on the bf16 tensor cores, p and ds as
three bf16 pieces each: csrc/attention_dropout.cuh).

The CUDA kernels are csrc/attention.cuh (K1) and
csrc/attention_dropout.cuh (K5, K6), built from attention.cu and
attention_dropout.cu (the release entry points) and from the options'
own sources; K1 and K5 run one forward tile per dtype
(csrc/attention_tile.cuh: 3xTF32 at fp32, bf16 mma.sync at bf16, so K5
at rate 0 is K1 bit for bit), and K1 splits each patch's query rows over
blocks by attention_query_split. At bf16 both stage k and v 16 bytes at a
time and read q in bf16 pairs, and K6 stages q, k, v, out and g 16 bytes at a
time: the wrappers hand them 16-byte aligned tensors (a copy of an
unaligned view).
The plain versions are the path for CPU tensors and the kernels' oracles;
patch_attention_dropout_plain and patch_attention_dropout_vjp_plain take
the keep mask as a (G, H, P, P) bool tensor.

The backbone's attention options (ptv3_config enable_rpe,
scaled_cosine_attn; models/layers.py SerializedAttention) enter K1, K5 and
K6 as two optional arguments, the JAX package's XLA attention (the path
its Pallas kernel leaves for them):
  head_scale (H,) fp32: the logits (q * scale) k^T, fp32, times the head's
    scale (scaled cosine attention's exp(min(logit_scale, log 100)), with
    q and k normalised outside and scale 1);
  rpe = (gc, table, b): gc (G, P, 3) int32 the patches' grid coordinates,
    table (3R, H) fp32, b the position bound (R = 2b + 1): the logits plus
    rpe_bias(table, gc_i - gc_j, b), before the key mask.
The kernels with either are their _opts entry points (counted as
patch_attention_opts, patch_attention_dropout_opts,
patch_attention_dropout_bwd_opts and their _bf16 paths); they look the
bias up from gc and the table inside the kernel. K6 also returns the
gradients of table and head_scale (its per-patch partials summed here in
a fixed order); _PatchAttentionDropout hands them to autograd.

With the options, fp32 q and k and a bf16 v (upcast_attention at bf16,
models/layers.py) are the JAX XLA path there: fp32 logits, the (dropped)
probabilities rounded to v's bf16 before P v, out fp32 (the layer rounds
it to bf16): K1 and K5's fp32 _opts kernels with the rounding on (the
_opts_mixed entry points, counted with the fp32 _opts kernels), v widened
to fp32 here. The backward is the fp32 K6 with the options on the
forward's saved state (unrounded probabilities in dv and ds, as bf16
training follows the TPU kernel's backward), dv returned in bf16.
"""
from __future__ import annotations

import ctypes

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


def pos_bound(P):
    """The relative-position bound of a patch of P keys, the JAX package's
    Python float expression (15 at P = 128, not 16)."""
    return int((4 * P) ** (1 / 3) * 2)


def rpe_bias(table, rel_pos, pos_bnd):
    """The learned relative-position bias (the JAX package's rpe_bias):
    rel_pos (..., 3) int grid-coordinate deltas, clipped to [-pos_bnd,
    pos_bnd] and shifted by pos_bnd + a (2 pos_bnd + 1) on axis a, index
    the rows of table (3 R, H); the three rows summed in axis order ->
    (..., H)."""
    R = 2 * pos_bnd + 1
    idx = (rel_pos.clamp(-pos_bnd, pos_bnd) + pos_bnd +
           torch.arange(3, device=rel_pos.device) * R).long()
    rows = table[idx]
    return rows[..., 0, :] + rows[..., 1, :] + rows[..., 2, :]


def _rpe_rel(gc):
    """(G, P, P, 3) grid-coordinate deltas, query less key."""
    return gc[:, :, None, :] - gc[:, None, :, :]


def _rpe_logit_bias(rpe):
    """The (G, H, P, P) bias of rpe = (gc, table, b)."""
    gc, table, b = rpe
    return rpe_bias(table.float(), _rpe_rel(gc), b).permute(0, 3, 1, 2)


def patch_attention_plain(q, k, v, key_valid, scale, head_scale=None,
                          rpe=None):
    """q/k/v: (G, H, P, Dh); key_valid: (G, P) bool -> (G, H, P, Dh);
    head_scale, rpe: the options (module docstring)."""
    return patch_attention_dropout_plain(q, k, v, key_valid, scale, 0.0, None,
                                         head_scale, rpe)


def _scaled(q, scale):
    """q * scale; for bf16 q, in bf16 as the JAX reference computes it."""
    if q.dtype == torch.bfloat16:
        return (q.float() * bf16_value(scale)).to(q.dtype)
    return q * scale


def _products(q, k, scale):
    """(q * scale) k^T in fp32, (G, H, P, P)."""
    return torch.einsum("ghpd,ghqd->ghpq", _scaled(q, scale).float(),
                        k.float())


def _opt_logits(S, head_scale, rpe):
    """The logits of products S under the options, before the mask."""
    if head_scale is not None:
        S = S * head_scale.float()[None, :, None, None]
    if rpe is not None:
        S = S + _rpe_logit_bias(rpe)
    return S


def _logits(q, k, key_valid, scale, head_scale=None, rpe=None):
    logits = _opt_logits(_products(q, k, scale), head_scale, rpe)
    return torch.where(key_valid[:, None, None, :], logits,
                       torch.full_like(logits, NEG_INF))


def bf16_probability_allowance(q, k, v, key_valid, scale, rate=0.0,
                               keep=None, head_scale=None, rpe=None):
    """2^-7 sum_j p_j |v_j| (G, H, P, Dh) fp32: one bf16 ulp of each
    probability's share of the output, the part of K1's (and, with the
    dropped probabilities of `rate` and `keep`, K5's) bf16 bar that a
    probability rounded to the neighbouring bf16 value can move
    (ops/bf16.py)."""
    a = _drop(torch.softmax(_logits(q, k, key_valid, scale, head_scale, rpe),
                            dim=-1), rate, keep)
    return torch.einsum("ghpq,ghqd->ghpd", a, v.float().abs()) * 2.0 ** -7


def _drop(t, rate, keep):
    """where(keep, t / (1 - rate), 0); keep None: keep all."""
    t = t / (1.0 - rate)
    return t if keep is None else torch.where(keep, t, torch.zeros_like(t))


def patch_attention_dropout_plain(q, k, v, key_valid, scale, rate, keep,
                                  head_scale=None, rpe=None):
    """keep: (G, H, P, P) bool (None: keep all) -> (G, H, P, Dh). The
    probabilities are cast to v's dtype before the product, which sums in
    fp32."""
    a = torch.softmax(_logits(q, k, key_valid, scale, head_scale, rpe),
                      dim=-1)
    return torch.einsum("ghpq,ghqd->ghpd",
                        _drop(a, rate, keep).to(v.dtype).float(),
                        v.float()).to(q.dtype)


def patch_attention_dropout_vjp_plain(q, k, v, key_valid, scale, rate, keep,
                                      g):
    """(dq, dk, dv) of patch_attention_dropout_plain for the cotangent g
    (keep None: keep all), recomputing the probabilities: the math of the
    JAX package's `_attn_drop_bwd_kernel`, with ds zeroed at masked keys
    (the exact gradient; the two differ only in a patch with no valid
    key). Without the options (autograd of the plain forward is their
    oracle)."""
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
    generator of csrc/attention_dropout.cuh)."""
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


def patch_attention_dropout_fwd_plain(q, k, v, key_valid, scale, rate, seed,
                                      head_scale=None, rpe=None):
    """K5's plain version: (out, lse, bits) with the Philox mask of
    `seed`; at bf16 the dropped probabilities are rounded to bf16 before
    the product (the module docstring)."""
    logits = _logits(q, k, key_valid, scale, head_scale, rpe)
    keep = _plain_keep(q, rate, seed)
    a = torch.softmax(logits, dim=-1)
    out = torch.einsum("ghpq,ghqd->ghpd",
                       _drop(a, rate, keep).to(v.dtype).float(), v.float())
    return (out.to(q.dtype), torch.logsumexp(logits, dim=-1),
            pack_keep_bits(keep))


def patch_attention_dropout_bwd_plain(q, k, v, key_valid, out, lse, bits, g,
                                      scale, rate, head_scale=None, rpe=None):
    """K6's plain version: (dq, dk, dv), fp32, from the forward's saved
    (q, k, v, key_valid, out, lse, bits) and the cotangent g, as K6
    computes them: p = exp(logits - lse), D = g . out, ds zeroed at masked
    keys, dk = ds^T (q * scale) and dq = (ds k) * scale, with q * scale
    and scale as the forward took them (bf16 at bf16); in a patch with no
    valid key p = 1 / P (lse rounds to -1e9 there). With the options ds
    (the logits' gradient) times head_scale is the products' gradient,
    and (dq, dk, dv, dtable, dhead_scale) is returned: dtable (3R, H) the
    sum of ds over each table row's (query, key) pairs, dhead_scale (H,)
    the sum of ds times the products (None where the option is off)."""
    P = q.shape[2]
    S = _products(q, k, scale)
    logits = torch.where(key_valid[:, None, None, :],
                         _opt_logits(S, head_scale, rpe),
                         torch.full_like(S, NEG_INF))
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
    if head_scale is None and rpe is None:
        dq = torch.einsum("ghpq,ghqd->ghpd", ds, k) * scale
        dk = torch.einsum("ghpq,ghpd->ghqd", ds, qs)
        return dq, dk, dv
    dtable = None if rpe is None else rpe_table_grad(ds, rpe)
    dhs = None if head_scale is None else \
        (ds * S).double().sum((0, 2, 3)).float()
    if head_scale is not None:
        ds = ds * head_scale.float()[None, :, None, None]
    dq = torch.einsum("ghpq,ghqd->ghpd", ds, k) * scale
    dk = torch.einsum("ghpq,ghpd->ghqd", ds, qs)
    return dq, dk, dv, dtable, dhs


def rpe_table_grad(ds, rpe):
    """(3R, H) fp32: the sum of ds (G, H, P, P), the logits' gradient, over
    the (query, key) pairs of each table row of rpe = (gc, table, b),
    accumulated in fp64 (a row sums up to G P^2 terms that largely cancel:
    each query's ds sums to 0 over its keys)."""
    gc, table, b = rpe
    R = 2 * b + 1
    H = ds.shape[1]
    idx = (_rpe_rel(gc).clamp(-b, b) + b +
           torch.arange(3, device=gc.device) * R).long()    # (G, P, P, 3)
    vals = ds.permute(0, 2, 3, 1).reshape(-1, H).double()
    out = torch.zeros(3 * R, H, dtype=torch.float64, device=ds.device)
    for a in range(3):
        out.index_add_(0, idx[..., a].reshape(-1), vals)
    return out.float()


def _mixed(q, v):
    """fp32 q with a bf16 v: upcast_attention at bf16 with the options."""
    return q.dtype == torch.float32 and v.dtype == torch.bfloat16


def _check_attention(name, q, k, v, key_valid, *more):
    """The kernels' contract: q, k, v and `more` contiguous CUDA tensors of
    one (G, H, P, Dh) shape and one dtype, fp32 or bf16 (v bf16 with fp32
    q and k on the mixed route), key_valid (G, P) bool."""
    for n, t in (("q", q), ("k", k), ("v", v),
                 *((f"arg {i}", t) for i, t in enumerate(more))):
        dtypes = (torch.float32, torch.bfloat16) if n == "q" else \
            (torch.bfloat16,) if n == "v" and _mixed(q, v) else (q.dtype,)
        cuda_lib.check_cuda_tensor(f"{name} {n}", t, dtypes, 4)
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


def _opt_args(name, q, head_scale, rpe):
    """The options' C arguments (hs, gc, table, b: NULL pointers where
    off; none without options) after checking them against q (G, H, P,
    Dh): head_scale (H,) fp32, gc (G, P, 3) int32, table (3R, H) fp32 with
    R = 2b + 1 and b at most the kernels' bound (that of P = 128)."""
    if head_scale is None and rpe is None:
        return ()
    G, H, P, _ = q.shape
    hs = gc = table = None
    b = 0
    if head_scale is not None:
        cuda_lib.check_cuda_tensor(f"{name} head_scale", head_scale,
                                   torch.float32, 1)
        if tuple(head_scale.shape) != (H,):
            raise ValueError(f"{name}: head_scale {tuple(head_scale.shape)}"
                             f" for {H} heads")
        hs = head_scale.data_ptr()
    if rpe is not None:
        gct, tab, b = rpe
        cuda_lib.check_cuda_tensor(f"{name} rpe gc", gct, torch.int32, 3)
        cuda_lib.check_cuda_tensor(f"{name} rpe table", tab, torch.float32,
                                   2)
        if not 0 <= b <= pos_bound(KERNEL_MAX_PATCH) or \
                tuple(gct.shape) != (G, P, 3) or \
                tuple(tab.shape) != (3 * (2 * b + 1), H):
            raise ValueError(f"{name}: rpe gc {tuple(gct.shape)}, table "
                             f"{tuple(tab.shape)}, bound {b} for q "
                             f"{tuple(q.shape)}")
        gc, table = gct.data_ptr(), tab.data_ptr()
    return hs, gc, table, b


def _opts_route(kernel, entry, q, v, head_scale, rpe, mixed_entry=True):
    """(counter, entry point, v) of a kernel with the options on, or as
    given without them; bf16 adds _bf16 to both; the mixed route (fp32 q,
    bf16 v, with the options) takes v widened to fp32 and the
    _opts_mixed entry point (K1, K5; with mixed_entry False, K6, the fp32
    _opts one), counted as the fp32 _opts kernel."""
    opts = head_scale is not None or rpe is not None
    if opts:
        kernel, entry = kernel + "_opts", entry + "_opts"
    if _mixed(q, v):
        if not opts:
            raise ValueError(f"{entry}: fp32 q with a bf16 v takes the "
                             "attention options")
        return kernel, entry + ("_mixed" if mixed_entry else ""), v.float()
    if q.dtype == torch.bfloat16:
        kernel, entry = kernel + "_bf16", entry + "_bf16"
    return kernel, entry, v


def patch_attention(q, k, v, key_valid, scale, head_scale=None, rpe=None):
    """Masked per-patch attention, q, k, v fp32 or bf16, with the options
    head_scale and rpe (module docstring): the CUDA kernel (K1) for CUDA
    tensors, the plain version for CPU tensors. K1 has no backward: a CUDA
    call that must carry a gradient raises (patch_attention_dropout has
    one)."""
    if not q.is_cuda:
        return patch_attention_plain(q, k, v, key_valid, scale, head_scale,
                                     rpe)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (q, k, v, head_scale, rpe and rpe[1])):
        raise RuntimeError("patch_attention (K1) has no backward; use "
                           "patch_attention_dropout for a gradient")
    G, H, P, _ = q.shape
    return patch_attention_split(q, k, v, key_valid, scale,
                                 *attention_query_split(G, H, P),
                                 head_scale=head_scale, rpe=rpe)


def patch_attention_split(q, k, v, key_valid, scale, warps, splits,
                          head_scale=None, rpe=None):
    """K1 on CUDA tensors with a given query split (attention_query_split
    gives patch_attention's); one launch."""
    G, H, P, Dh = _check_attention("patch_attention", q, k, v, key_valid)
    if not 1 <= warps <= ATTN_MAX_WARPS or splits < 1 or \
            QUERY_ROWS * warps * splits < P:
        raise ValueError(f"patch_attention: split ({warps} warps, {splits} "
                         f"blocks) does not cover {P} query rows")
    out = torch.empty_like(q)
    kernel, entry, v = _opts_route("patch_attention", "r3dl_patch_attention",
                                   q, v, head_scale, rpe)
    k, v = _aligned(k), _aligned(v)
    if q.dtype == torch.bfloat16:
        q = _aligned(q)
        scale = bf16_value(scale)
    opts = _opt_args("patch_attention", q, head_scale, rpe)
    cuda_lib.launch(kernel, entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    key_valid.data_ptr(), out.data_ptr(), *opts, G, H, P, Dh,
                    warps, splits, float(scale))
    return out


def _dropout_args(rate, seed):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention dropout rate {rate} not in [0, 1)")
    if not 0 <= seed < (1 << 32):
        raise ValueError(f"attention dropout seed {seed} not a uint32")
    return seed, keep_threshold(rate), 1.0 / (1.0 - rate)


def _dropout_route(q, v, scale, kernel, entry, head_scale, rpe,
                   mixed_entry=True):
    """(counter, entry point, scale, v) of K5 or K6 for q's dtype and the
    options (_opts_route): at bf16 the _bf16 entry and scale rounded to
    bf16, as K1's bf16 path takes it."""
    kernel, entry, v = _opts_route(kernel, entry, q, v, head_scale, rpe,
                                   mixed_entry)
    if q.dtype == torch.bfloat16:
        return kernel, entry, bf16_value(scale), v
    return kernel, entry, float(scale), v


def patch_attention_dropout_fwd(q, k, v, key_valid, scale, rate, seed,
                                head_scale=None, rpe=None):
    """(out, lse, bits) of the training attention, q, k, v fp32 or bf16
    (lse fp32), with the options head_scale and rpe: K5 for CUDA tensors,
    the plain version for CPU tensors."""
    seed, thresh, inv_keep = _dropout_args(rate, seed)
    if not q.is_cuda:
        return patch_attention_dropout_fwd_plain(q, k, v, key_valid, scale,
                                                 rate, seed, head_scale, rpe)
    G, H, P, Dh = _check_attention("patch_attention_dropout", q, k, v,
                                   key_valid)
    if q.dtype == torch.bfloat16:
        q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = q.new_empty((G, H, P), dtype=torch.float32)
    bits = torch.empty((G, H, P, (P + 31) // 32), dtype=torch.int32,
                       device=q.device)
    kernel, entry, scale, v = _dropout_route(
        q, v, scale, "patch_attention_dropout", "r3dl_attention_dropout_fwd",
        head_scale, rpe)
    opts = _opt_args("patch_attention_dropout", q, head_scale, rpe)
    cuda_lib.launch(kernel, entry,
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    key_valid.data_ptr(), out.data_ptr(), lse.data_ptr(),
                    bits.data_ptr(), *opts, G, H, P, Dh, scale, seed, thresh,
                    inv_keep)
    return out, lse, bits


def patch_attention_dropout_bwd(q, k, v, key_valid, out, lse, bits, g, scale,
                                rate, head_scale=None, rpe=None):
    """(dq, dk, dv) of patch_attention_dropout for the cotangent g, from
    what the forward returned, in q's dtype: K6 for CUDA tensors, the plain
    version for CPU tensors. With the options, (dq, dk, dv, dtable,
    dhead_scale) as patch_attention_dropout_bwd_plain returns them (fp32;
    None where off); K6 writes one partial per (patch, head), summed here
    over the patches in a fixed order."""
    opt = head_scale is not None or rpe is not None
    if not q.is_cuda:
        grads = patch_attention_dropout_bwd_plain(
            q, k, v, key_valid, out, lse, bits, g, scale, rate, head_scale,
            rpe)
        return (grads[0].to(q.dtype), grads[1].to(k.dtype),
                grads[2].to(v.dtype)) + tuple(grads[3:])
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
    v_dtype = v.dtype
    kernel, entry, scale, v = _dropout_route(
        q, v, scale, "patch_attention_dropout_bwd",
        "r3dl_attention_dropout_bwd", head_scale, rpe, mixed_entry=False)
    if q.dtype == torch.bfloat16:
        q, k, v, out, g = (_aligned(t) for t in (q, k, v, out, g))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    opts, dtab, dhs = (), None, None
    if opt:
        hs, gc, table, b = _opt_args("patch_attention_dropout_bwd", q,
                                     head_scale, rpe)
        if rpe is not None:
            dtab = torch.empty((G, 3 * (2 * b + 1), H), dtype=torch.float32,
                               device=q.device)
        if head_scale is not None:
            dhs = torch.empty((G, H), dtype=torch.float32, device=q.device)
        opts = (hs, gc, table, b, None if dtab is None else dtab.data_ptr(),
                None if dhs is None else dhs.data_ptr())
    cuda_lib.launch(kernel, entry, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), key_valid.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), bits.data_ptr(), g.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *opts, G, H,
                    P, Dh, scale, 1.0 / (1.0 - rate))
    dv = dv.to(v_dtype)
    if not opt:
        return dq, dk, dv
    return (dq, dk, dv, None if dtab is None else dtab.sum(0),
            None if dhs is None else dhs.sum(0))


class _PatchAttentionDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_valid, scale, rate, seed, head_scale, gc,
                table, b):
        rpe = None if gc is None else (gc, table, b)
        out, lse, bits = patch_attention_dropout_fwd(
            q, k, v, key_valid, scale, rate, seed, head_scale, rpe)
        ctx.save_for_backward(q, k, v, key_valid, out, lse, bits, head_scale,
                              gc, table)
        ctx.args = (scale, rate, b)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv, out, lse, bits, hs, gc, table = ctx.saved_tensors
        scale, rate, b = ctx.args
        rpe = None if gc is None else (gc, table, b)
        grads = patch_attention_dropout_bwd(q, k, v, kv, out, lse, bits,
                                            g.contiguous(), scale, rate, hs,
                                            rpe)
        dtab, dhs = grads[3:] if len(grads) > 3 else (None, None)
        return (*grads[:3], None, None, None, None, dhs, None, dtab, None)


def patch_attention_dropout(q, k, v, key_valid, scale, rate, seed,
                            head_scale=None, rpe=None):
    """Training attention with in-kernel dropout (K5 forward, K6 backward)
    for CUDA tensors; the plain versions with philox_keep_mask for CPU
    tensors. seed: a uint32 int, one per call (the wrapper's generator
    draws it); at rate 0 this is exact attention and its exact backward.
    head_scale, rpe: the options (module docstring); their gradients reach
    head_scale and rpe's table."""
    gc, table, b = (None, None, 0) if rpe is None else rpe
    return _PatchAttentionDropout.apply(q, k, v, key_valid, float(scale),
                                        float(rate), int(seed), head_scale,
                                        gc, table, int(b))


def bwd_opts_blocks_per_sm(dtype, head_dim, head_scale=True, rpe=True):
    """Blocks of K6 with the options (head_scale and / or rpe on) that one
    SM of the card holds at head_dim, its shared memory opted into
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); the design's two, as
    the release K6's."""
    n = ctypes.c_int(0)
    cuda_lib.query("r3dl_attention_dropout_bwd_opts_blocks" +
                   ("_bf16" if dtype == torch.bfloat16 else ""),
                   int(head_dim), int(bool(head_scale)), int(bool(rpe)),
                   ctypes.addressof(n))
    return n.value
