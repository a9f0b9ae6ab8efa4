"""PyTorch building blocks of the PointTransformerV3 stack (port of
robot3dlotus_tpu/models/layers.py).

Tensors are padded dense (B, N, C) with validity masks, as in the JAX
package. Submodules carry the flax module names (qkv, cpe_conv, norm1,
...) so that convert.params_from_jax maps a JAX variable tree onto the
state_dict mechanically.

Compute dtype (ptv3_config compute_dtype, the flax modules' `dtype`):
None computes in fp32. torch.bfloat16 computes what the JAX package
computes under 'bfloat16', with the parameters kept fp32 (so the
state_dict is the fp32 one) and cast to bf16 at each call: Dense casts
its input, weight and bias, its product sums in fp32 and is rounded to
bf16, and the bias is added in bf16 (flax Dense); the norms compute in
fp32 and return their input's dtype; SubMConv casts x and its weight (not
the bias); the attentions keep fp32 logits and softmax and cast the
probabilities to bf16. No autocast: the dtypes are the modules'.

Train mode (nn.Module.train()) is the JAX package's deterministic=False:
batch norms use the masked batch statistics and update their running ones,
and dropout, attention dropout and drop-path draw from an explicit
`Randomness`. Eval mode uses the running statistics and no dropout.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import (patch_attention, patch_attention_dropout,
                             pos_bound, rpe_bias)  # noqa: F401 (rpe_bias:
# the plain bias lookup of the layer's option, kept beside it)
from ..ops.patching import dup_pad_identity, gather_sorted, scatter_back
from ..ops.sparse_conv import NeighborMap, subm_conv_apply
from ..parallel import dist


def trunc_normal_(t, generator, std=0.02):
    """flax truncated_normal(stddev=std, lower=-2, upper=2): a unit normal
    truncated to [-2, 2], rescaled so its std is `std`."""
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        t.mul_(std / 0.87962566103423978)
    return t


def resolve_compute_dtype(name):
    """ptv3_config compute_dtype -> None (fp32) or torch.bfloat16, the one
    narrower dtype the port's kernels take."""
    if name in (None, "float32", "fp32"):
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"compute_dtype {name!r}: the PyTorch port computes "
                     "in float32 (None) or bfloat16")


class Dense(nn.Linear):
    """flax Dense(dtype): with a compute dtype the input, weight and bias
    are cast to it, the product sums in fp32 and is rounded to it, and the
    bias is added in it; without one, nn.Linear."""

    def __init__(self, cin, cout, bias=True, dtype=None):
        super().__init__(cin, cout, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


def dense(cin, cout, generator, bias=True, dtype=None):
    """Dense with the JAX package's init: truncated normal (std 0.02)
    weight, zero bias."""
    lin = Dense(cin, cout, bias=bias, dtype=dtype)
    with torch.no_grad():
        trunc_normal_(lin.weight, generator)
        if bias:
            lin.bias.zero_()
    return lin


class LayerNorm(nn.LayerNorm):
    """The JAX LayerNorm: statistics, normalisation and affine in fp32, the
    result in the input's dtype (a bf16 input is widened first)."""

    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        return super().forward(x.float()).to(x.dtype)


# sqrt(1/2) rounded to bf16: jax.nn.gelu's constant for a bf16 input
_SQRT_HALF_BF16 = 0.70703125


def gelu(x):
    """The exact (erf) GELU, like jax.nn.gelu(approximate=False). A bf16 x
    takes that function's own ops, each rounded to bf16: 0.5 x erfc(-x
    sqrt(1/2)) with sqrt(1/2) a bf16 constant (four kernels where F.gelu,
    which rounds once, is one)."""
    if x.dtype == torch.bfloat16:
        return 0.5 * x * torch.erfc(x * -_SQRT_HALF_BF16)
    return F.gelu(x)


class Randomness:
    """The random numbers of one train-mode forward: dropout masks from
    `device` (a generator on the tensors' device), attention-dropout seeds
    and SFC order permutations from `host` (a CPU generator, no device
    sync). `perms`, when given, is the list of order permutations to hand
    out instead, in call order (tests feed both packages the same ones).

    The trainer calls at_step(step) before each step, as the JAX step
    folds state.step into its key: both generators restart from a seed
    derived from (seed, step), so a run resumed at a step draws what the
    uninterrupted run drew there."""

    def __init__(self, seed, device="cpu", perms=None):
        device = torch.device(device)
        self.seed = seed
        self.host = torch.Generator().manual_seed(seed)
        self.device = torch.Generator(device=device).manual_seed(seed + 1)
        self.perms = None if perms is None else [list(p) for p in perms]

    def at_step(self, step):
        """Reseeds both generators from (seed, step)."""
        host, dev = np.random.SeedSequence([self.seed, step]).generate_state(
            2, np.uint64)
        self.host.manual_seed(int(host))
        self.device.manual_seed(int(dev))

    def keep(self, shape, rate, device):
        """Bernoulli(1 - rate) keep mask of `shape`."""
        return torch.rand(shape, generator=self.device, device=device) >= rate

    def seed32(self):
        return int(torch.randint(0, 1 << 32, (), generator=self.host,
                                 dtype=torch.int64))

    def permutation(self, n):
        if self.perms is not None:
            p = self.perms.pop(0)
            if sorted(p) != list(range(n)):
                raise ValueError(f"injected order permutation {p} is not a "
                                 f"permutation of {n}")
            return p
        return torch.randperm(n, generator=self.host).tolist()


def _drop(x, rate, training, rng, shape, tp=None):
    if not training or rate == 0.0:
        return x
    if rng is None:
        raise ValueError("train-mode dropout needs a Randomness")
    if tp is None:
        keep = rng.keep(shape, rate, x.device)
    else:               # the whole width's mask, this process's columns
        keep = rng.keep(shape[:-1] + (shape[-1] * tp.size,), rate,
                        x.device)[..., tp.cols(shape[-1] * tp.size)]
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dropout(x, rate, training, rng, tp=None):
    """flax nn.Dropout: keep with probability 1 - rate, scale by
    1 / (1 - rate); the identity in eval mode or at rate 0. With `tp` (a
    parallel.mesh.TPShard) x is this process's columns of a tp-sharded
    activation: the mask is drawn at the whole width and cut to them, so
    the tp processes draw what one process draws."""
    return _drop(x, rate, training, rng, x.shape, tp)


def drop_path(x, rate, training, rng):
    """Per-row stochastic depth over the point axis (JAX drop_path)."""
    return _drop(x, rate, training, rng, x.shape[:-1] + (1,))


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the valid points of the batch (eps 1e-3, momentum
    0.01 in the torch convention). Train mode normalises with the masked
    batch mean and biased variance and moves the running statistics
    towards the mean and the unbiased variance; eval mode uses the running
    statistics. Computed in fp32, returned in x's dtype. In a process
    group (parallel/dist.py) the batch is that of `group`, the batch group
    the trainer sets (None: every process): the count and the masked sum,
    then the masked squared deviations, are summed over its processes
    (their gradient too), as the JAX batch norm's sums span its dp mesh,
    so the statistics move the same on every process (under the manual
    ZeRO-1 step the group is dist.LOCAL: its own shard's statistics,
    parallel/zero.py)."""

    def __init__(self, features, eps=1e-3, momentum=0.01):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.group = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, mask=None):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            xf = x.float().reshape(-1, x.shape[-1])
            if mask is None:
                m = torch.ones_like(xf[:, :1])
            else:
                m = mask.reshape(-1, 1).to(xf.dtype)
            cnt, total = m.sum(), (xf * m).sum(0)
            summed = dist.reduces(self.group)
            if summed:
                both = dist.sum_across(torch.cat([total, cnt[None]]),
                                       self.group)
                total, cnt = both[:-1], both[-1]
            cnt = cnt.clamp(min=1.0)
            mean = total / cnt
            dev = (((xf - mean) ** 2) * m).sum(0)
            var = (dist.sum_across(dev, self.group) if summed else dev) / cnt
            with torch.no_grad():
                unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
                self.running_mean.mul_(1 - self.momentum).add_(
                    self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * unbiased)
        y = (x.float() - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class AdaptiveNorm(nn.Module):
    """The JAX AdaptiveNorm: a base norm held as `.norm`, so parameter
    names match the flax tree; the point mask feeds only the batch norm's
    statistics. Adaptive (the AdaNorm variant's PDNorm): `modulation`
    = Linear(C_ctx, 2 C) on silu(context), split shift first, then scale,
    and y (1 + scale) + shift broadcast over the points of each cloud,
    the modulation cast to y's dtype (its Dense computes in `dtype`)."""

    def __init__(self, features, kind, generator=None, adaptive=False,
                 context_channels=256, dtype=None):
        super().__init__()
        self.kind = kind
        self.norm = MaskedBatchNorm(features) if kind == "bn" else \
            LayerNorm(features, eps=1e-5)
        if adaptive:
            self.modulation = dense(context_channels, 2 * features,
                                    generator, dtype=dtype)

    def forward(self, x, mask=None, context=None):
        y = self.norm(x, mask) if self.kind == "bn" else self.norm(x)
        if hasattr(self, "modulation"):
            if context is None:
                raise ValueError("an adaptive norm needs the context vector")
            shift, scale = self.modulation(F.silu(context)).to(
                y.dtype).chunk(2, dim=-1)
            y = y * (1.0 + scale[:, None, :]) + shift[:, None, :]
        return y


def row_parallel(lin, x, tp):
    """A row-parallel Dense (its weight this process's input columns) on
    x, this process's columns: the partial products summed over the tp
    group (Megatron's g), then the whole bias added once. With a compute
    dtype the partials are the products of the dtype's operands summed in
    fp32 (exact for bf16 operands), so the sum is rounded once, as the
    one-process Dense rounds its product."""
    dt = lin.compute_dtype
    if dt is None:
        y = dist.reduce_from_tp(F.linear(x, lin.weight), tp.group)
        return y if lin.bias is None else y + lin.bias
    y = dist.reduce_from_tp(F.linear(x.to(dt).float(),
                                     lin.weight.to(dt).float()), tp.group)
    y = y.to(dt)
    return y if lin.bias is None else y + lin.bias.to(dt)


class MLP(nn.Module):
    """fc1, gelu, dropout, fc2, dropout. Tensor-parallel form (tp, a
    parallel.mesh.TPShard, set by parallel.mesh.shard_model): fc1
    column-parallel behind Megatron's f, fc2 row-parallel (row_parallel);
    the hidden's dropout takes this process's columns of the whole
    mask."""

    tp = None

    def __init__(self, cin, hidden, cout, generator, drop=0.0, dtype=None):
        super().__init__()
        self.drop = drop
        self.fc1 = dense(cin, hidden, generator, dtype=dtype)
        self.fc2 = dense(hidden, cout, generator, dtype=dtype)

    def forward(self, x, rng=None):
        tp = self.tp
        if tp is None:
            x = dropout(gelu(self.fc1(x)), self.drop, self.training, rng)
            return dropout(self.fc2(x), self.drop, self.training, rng)
        x = gelu(self.fc1(dist.copy_to_tp(x, tp.group)))
        x = dropout(x, self.drop, self.training, rng, tp)
        return dropout(row_parallel(self.fc2, x, tp), self.drop,
                       self.training, rng)


class SubMConv(nn.Module):
    """Submanifold sparse conv; weight (K, Cin + E, Cout) in
    stencil_offsets order, spconv-like uniform init over fan_in =
    K * (Cin + E). E = categorical_channels: the width of an embedded
    categorical input (the motion planner's point labels) that forward
    takes as `categorical` = (idx (B, N), table (Kcat, E)). With a compute
    dtype x and the weight are cast to it (the bias stays fp32; the conv
    sums in fp32 and rounds once)."""

    def __init__(self, cin, cout, kernel_size, generator, use_bias=True,
                 categorical_channels=0, dtype=None):
        super().__init__()
        self.compute_dtype = dtype
        K = kernel_size ** 3
        cin = cin + categorical_channels
        bound = math.sqrt(1.0 / (K * cin))
        self.weight = nn.Parameter(
            (torch.rand(K, cin, cout, generator=generator) * 2 - 1) * bound)
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x, nmap: NeighborMap, categorical=None):
        weight, dt = self.weight, self.compute_dtype
        if dt is not None:
            x, weight = x.to(dt), weight.to(dt)
        return subm_conv_apply(x, nmap, weight, self.bias,
                               categorical=categorical)


def cosine_normalize(x):
    """x / max(||x||, 1e-12) over the last axis in x's dtype, as the JAX
    package computes it (jnp.linalg.norm: the squares rounded to x's
    dtype, summed in fp32 and rounded, the root in x's dtype). A zero row
    (a dead slot whose input is zero, at init) has a zero gradient: the
    sum of squares is clamped at 1e-30 before the root, which moves no
    value past the 1e-12 clamp; the JAX package's root there gives
    0 x inf = NaN."""
    if x.dtype == torch.float32:
        return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1,
                                                            keepdim=True),
                                   1e-12)
    ss = (x * x).float().sum(-1, keepdim=True).to(x.dtype)
    return x / torch.clamp_min(torch.sqrt(torch.clamp_min(ss, 1e-30)), 1e-12)


LOG_100 = math.log(100.0)


class SerializedAttention(nn.Module):
    """Patch attention over one serialized order. The input is arranged in
    padded serialized order (a shift+select when the stream already lives
    in that order), projected to q/k/v, qk-normed (eps 1e-6) and attended
    per patch with fp32 softmax; masked keys get -1e9: K1 in eval mode,
    K5 (backward K6) with the attention-dropout rate in train mode.

    The attention options (the JAX SerializedAttention's; all off in the
    release configs), each computed as the JAX package's XLA path does:
    add_coords_in_attn 'qkv' / 'qk' adds coords_proj (Dense 3 -> C, no
    bias) of the stage's point coordinates, in padded serialized order and
    the compute dtype, to the input of qkv, or to its q and k thirds;
    upcast_attention widens q and k to fp32 before the qk norms; at bf16
    the attention then follows the JAX path that runs: without
    enable_rpe and scaled_cosine_attn its Pallas path, q and k cast back
    to bf16 after the norms, so the bf16 K1 / K5 / K6 run; with either,
    its XLA path, fp32 q and k with the bf16 v, the probabilities rounded
    to bf16 before P v (ops/attention.py, the mixed route of the _opts
    kernels); scaled_cosine_attn normalises q and
    k (cosine_normalize) and scales each head's fp32 logits by
    exp(min(logit_scale, log 100)) in place of qk_scale; enable_rpe adds
    the learned bias rpe_table (3 R, H) of the patch's grid-coordinate
    deltas (rpe_bias, bound b = pos_bound(P), R = 2b + 1). The last two go
    into K1 / K5 / K6 (head_scale and rpe): no plain attention on the
    card. patch_size is the patch the rpe table is sized for: the
    backbone's min(patch, stage capacity), as the JAX backbone passes it;
    a forward whose capacity gives another patch raises then."""

    def __init__(self, channels, num_heads, patch_size, generator,
                 order_index=0, qkv_bias=True, qk_scale=None, qk_norm=True,
                 attn_drop=0.0, proj_drop=0.0, dtype=None,
                 upcast_attention=False, scaled_cosine_attn=False,
                 enable_rpe=False, add_coords_in_attn="none"):
        super().__init__()
        if add_coords_in_attn not in ("none", "qkv", "qk"):
            raise ValueError(f"add_coords_in_attn {add_coords_in_attn!r} "
                             "not in ('none', 'qkv', 'qk')")
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.channels, self.num_heads = channels, num_heads
        self.patch_size, self.order_index = patch_size, order_index
        self.head_dim = channels // num_heads
        self.scale = qk_scale or self.head_dim ** -0.5
        self.upcast_attention = upcast_attention
        self.scaled_cosine_attn, self.enable_rpe = (scaled_cosine_attn,
                                                    enable_rpe)
        self.add_coords_in_attn = add_coords_in_attn
        self.qkv = dense(channels, 3 * channels, generator, bias=qkv_bias,
                         dtype=dtype)
        self.qk_norm = qk_norm
        if qk_norm:
            self.q_norm = LayerNorm(self.head_dim, eps=1e-6)
            self.k_norm = LayerNorm(self.head_dim, eps=1e-6)
        self.proj = dense(channels, channels, generator, dtype=dtype)
        if add_coords_in_attn != "none":
            self.coords_proj = dense(3, channels, generator, bias=False,
                                     dtype=dtype)
        if scaled_cosine_attn:
            # torch layout (H, 1, 1), init log 10
            self.logit_scale = nn.Parameter(
                torch.full((num_heads, 1, 1), math.log(10.0)))
        if enable_rpe:
            self.pos_bnd = pos_bound(patch_size)
            self.rpe_table = nn.Parameter(trunc_normal_(
                torch.empty(3 * (2 * self.pos_bnd + 1), num_heads),
                generator))

    @staticmethod
    def _padded(x, aux, order, P):
        """x (B, N, D) in padded serialized order, as the block's input
        (the grid coordinates, an int tensor, by a plain gather)."""
        if order is None:
            return dup_pad_identity(x, aux["counts"], P)
        if x.is_floating_point():
            return gather_sorted(x, order, aux["src_pos"])
        idx = torch.gather(order, -1, aux["src_pos"].long())
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

    def forward(self, feat, aux, rng=None):
        B, N, C = feat.shape
        H, Dh = self.num_heads, self.head_dim
        P = min(self.patch_size, N)
        order = aux["order"][self.order_index]
        inverse = aux["inverse"][self.order_index]
        feat = self._padded(feat, aux, order, P)
        if self.add_coords_in_attn != "none":
            qkc = self.coords_proj(
                self._padded(aux["coord"], aux, order, P).to(feat.dtype))
            if self.add_coords_in_attn == "qkv":
                feat = feat + qkc
        qkv = self.qkv(feat)
        if self.add_coords_in_attn == "qk":
            qkv = qkv + torch.cat([qkc, qkc, torch.zeros_like(qkc)], -1)
        NP = N // P
        q, k, v = (t.reshape(B, NP, P, H, Dh) for t in qkv.split(C, dim=-1))
        if self.upcast_attention:
            q, k = q.float(), k.float()
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        scale, head_scale, rpe = self.scale, None, None
        if self.scaled_cosine_attn:
            q, k = cosine_normalize(q), cosine_normalize(k)
            scale = 1.0
            head_scale = torch.exp(torch.clamp(
                self.logit_scale.reshape(H), max=LOG_100))
        if q.dtype != v.dtype and head_scale is None and \
                not self.enable_rpe:
            # upcast_attention at bf16 without the options: the JAX
            # Pallas path casts q and k back after the norms
            q, k = q.to(v.dtype), k.to(v.dtype)
        # (B, NP, P, H, Dh) -> (B*NP, H, P, Dh): the JAX kernel layout
        qg, kg, vg = (t.permute(0, 1, 3, 2, 4).reshape(B * NP, H, P, Dh)
                      .contiguous() for t in (q, k, v))
        kv = aux["key_valid"].reshape(B * NP, P)
        if self.enable_rpe:
            if pos_bound(P) != self.pos_bnd:
                raise ValueError(
                    f"enable_rpe: the rpe table is sized for patches of "
                    f"{self.patch_size} (bound {self.pos_bnd}); this stage's "
                    f"capacity {N} gives patches of {P}")
            gc = self._padded(aux["grid_coord"].to(torch.int32), aux, order,
                              P)
            rpe = (gc.reshape(B * NP, P, 3).contiguous(), self.rpe_table,
                   self.pos_bnd)
        # the options' arguments only where one is on: the release calls
        # keep their signature
        opts = () if head_scale is None and rpe is None else (head_scale,
                                                              rpe)
        if self.training:
            rate = self.attn_drop
            seed = rng.seed32() if rate > 0.0 else 0
            og = patch_attention_dropout(qg, kg, vg, kv, scale, rate, seed,
                                         *opts)
        else:
            og = patch_attention(qg, kg, vg, kv, scale, *opts)
        out = og.reshape(B, NP, H, P, Dh).permute(0, 1, 3, 2, 4)
        out = out.reshape(B, N, C).to(qkv.dtype)
        if inverse is not None:
            out = scatter_back(out.contiguous(), inverse)
        return dropout(self.proj(out), self.proj_drop, self.training, rng)


class CrossAttention(nn.Module):
    """Points -> text-token cross attention; masked tokens get -1e4; fp32
    logits and softmax, the probabilities cast to v's dtype, the product
    summed in fp32 and returned in q's dtype."""

    def __init__(self, channels, num_heads, context_channels, generator,
                 qk_norm=True, attn_drop=0.0, proj_drop=0.0, dtype=None):
        super().__init__()
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.num_heads = num_heads
        self.head_dim = channels // num_heads
        self.q = dense(channels, channels, generator, dtype=dtype)
        self.kv = dense(context_channels, 2 * channels, generator,
                        dtype=dtype)
        self.qk_norm = qk_norm
        if qk_norm:
            self.q_norm = LayerNorm(self.head_dim, eps=1e-6)
            self.k_norm = LayerNorm(self.head_dim, eps=1e-6)
        self.proj = dense(channels, channels, generator, dtype=dtype)

    def forward(self, feat, context, context_mask, rng=None):
        B, N, C = feat.shape
        T = context.shape[1]
        H, Dh = self.num_heads, self.head_dim
        q = self.q(feat).reshape(B, N, H, Dh)
        k, v = (t.reshape(B, T, H, Dh)
                for t in self.kv(context).split(C, dim=-1))
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        logits = torch.einsum("bnhd,bthd->bnth", q.float(),
                              k.float()) * Dh ** -0.5
        logits = torch.where(context_mask[:, None, :, None], logits,
                             torch.full_like(logits, -1e4))
        attn = torch.softmax(logits.float(), dim=2)
        attn = dropout(attn, self.attn_drop, self.training, rng)
        out = torch.einsum("bnth,bthd->bnhd", attn.to(v.dtype).float(),
                           v.float()).to(q.dtype)
        return dropout(self.proj(out.reshape(B, N, C)), self.proj_drop,
                       self.training, rng)


class Block(nn.Module):
    """PTv3 block: CPE conv residual (K2 conv -> linear -> LN), pre-norm
    patch attention, pre-norm MLP. Under AdaNorm (norm_adaptive) its three
    norms are adaptive, modulated by the per-cloud context vector.
    Tensor-parallel form (tp, set by parallel.mesh.shard_model): cpe_conv
    column-parallel on its Cout behind Megatron's f, cpe_fc row-parallel
    (row_parallel), so cpe_norm sees the whole sum."""

    tp = None

    def __init__(self, channels, num_heads, patch_size, generator,
                 mlp_ratio=4.0, qkv_bias=True, qk_scale=None, qk_norm=True,
                 order_index=0, attn_drop=0.0, proj_drop=0.0, drop_path=0.0,
                 norm_adaptive=False, context_channels=256, dtype=None,
                 **attn_opts):
        """attn_opts: SerializedAttention's options (upcast_attention,
        scaled_cosine_attn, enable_rpe, add_coords_in_attn)."""
        super().__init__()
        self.drop_path = drop_path
        norm = dict(generator=generator, adaptive=norm_adaptive,
                    context_channels=context_channels, dtype=dtype)
        self.cpe_conv = SubMConv(channels, channels, 3, generator,
                                 dtype=dtype)
        self.cpe_fc = dense(channels, channels, generator, dtype=dtype)
        self.cpe_norm = AdaptiveNorm(channels, "ln", **norm)
        self.norm1 = AdaptiveNorm(channels, "ln", **norm)
        self.attn = SerializedAttention(
            channels, num_heads, patch_size, generator,
            order_index=order_index, qkv_bias=qkv_bias, qk_scale=qk_scale,
            qk_norm=qk_norm, attn_drop=attn_drop, proj_drop=proj_drop,
            dtype=dtype, **attn_opts)
        self.norm2 = AdaptiveNorm(channels, "ln", **norm)
        self.mlp = MLP(channels, int(channels * mlp_ratio), channels,
                       generator, drop=proj_drop, dtype=dtype)

    def forward(self, feat, aux, cpe_feat=None, rng=None, context_vec=None):
        """cpe_feat: the stale CPE input of the first decoder block after an
        unpool — the upstream SerializedUnpooling never refreshes the
        sparse-conv feature buffer, so that block's conv reads the bare
        proj_skip output (released checkpoints were trained that way)."""
        x = feat if cpe_feat is None else cpe_feat
        if self.tp is None:
            cpe = self.cpe_fc(self.cpe_conv(x, aux["cpe_nmap"]))
        else:
            cpe = row_parallel(self.cpe_fc, self.cpe_conv(
                dist.copy_to_tp(x, self.tp.group), aux["cpe_nmap"]), self.tp)
        feat = feat + self.cpe_norm(cpe, context=context_vec)
        x = self.attn(self.norm1(feat, context=context_vec), aux, rng)
        feat = feat + drop_path(x, self.drop_path, self.training, rng)
        x = self.mlp(self.norm2(feat, context=context_vec), rng)
        return feat + drop_path(x, self.drop_path, self.training, rng)


class CABlock(nn.Module):
    """Cross-attention block after each self-attention block (CA variant,
    whose norms are never adaptive)."""

    def __init__(self, channels, num_heads, context_channels, generator,
                 mlp_ratio=4.0, qk_norm=True, attn_drop=0.0, proj_drop=0.0,
                 dtype=None):
        super().__init__()
        self.norm1 = AdaptiveNorm(channels, "ln")
        self.attn = CrossAttention(channels, num_heads, context_channels,
                                   generator, qk_norm=qk_norm,
                                   attn_drop=attn_drop, proj_drop=proj_drop,
                                   dtype=dtype)
        self.norm2 = AdaptiveNorm(channels, "ln")
        self.mlp = MLP(channels, int(channels * mlp_ratio), channels,
                       generator, drop=proj_drop, dtype=dtype)

    def forward(self, feat, context, context_mask, rng=None):
        feat = feat + self.attn(self.norm1(feat), context, context_mask, rng)
        return feat + self.mlp(self.norm2(feat), rng)
