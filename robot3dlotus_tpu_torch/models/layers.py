"""PyTorch building blocks of the PointTransformerV3 stack (port of
robot3dlotus_tpu/models/layers.py).

Tensors are padded dense (B, N, C) with validity masks, as in the JAX
package. Submodules carry the flax module names (qkv, cpe_conv, norm1,
...) so that convert.params_from_jax maps a JAX variable tree onto the
state_dict mechanically.

Train mode (nn.Module.train()) is the JAX package's deterministic=False:
batch norms use the masked batch statistics and update their running ones,
and dropout, attention dropout and drop-path draw from an explicit
`Randomness`. Eval mode uses the running statistics and no dropout.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import patch_attention, patch_attention_dropout
from ..ops.patching import dup_pad_identity, gather_sorted, scatter_back
from ..ops.sparse_conv import NeighborMap, subm_conv_apply


def trunc_normal_(t, generator, std=0.02):
    """flax truncated_normal(stddev=std, lower=-2, upper=2): a unit normal
    truncated to [-2, 2], rescaled so its std is `std`."""
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        t.mul_(std / 0.87962566103423978)
    return t


def dense(cin, cout, generator, bias=True):
    """nn.Linear with the JAX package's init: truncated normal (std 0.02)
    weight, zero bias."""
    lin = nn.Linear(cin, cout, bias=bias)
    with torch.no_grad():
        trunc_normal_(lin.weight, generator)
        if bias:
            lin.bias.zero_()
    return lin


def gelu(x):
    return F.gelu(x)  # exact erf form, like jax.nn.gelu(approximate=False)


class Randomness:
    """The random numbers of one train-mode forward: dropout masks from
    `device` (a generator on the tensors' device), attention-dropout seeds
    and SFC order permutations from `host` (a CPU generator, no device
    sync). `perms`, when given, is the list of order permutations to hand
    out instead, in call order (tests feed both packages the same ones)."""

    def __init__(self, seed, device="cpu", perms=None):
        device = torch.device(device)
        self.host = torch.Generator().manual_seed(seed)
        self.device = torch.Generator(device=device).manual_seed(seed + 1)
        self.perms = None if perms is None else [list(p) for p in perms]

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


def _drop(x, rate, training, rng, shape):
    if not training or rate == 0.0:
        return x
    if rng is None:
        raise ValueError("train-mode dropout needs a Randomness")
    keep = rng.keep(shape, rate, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dropout(x, rate, training, rng):
    """flax nn.Dropout: keep with probability 1 - rate, scale by
    1 / (1 - rate); the identity in eval mode or at rate 0."""
    return _drop(x, rate, training, rng, x.shape)


def drop_path(x, rate, training, rng):
    """Per-row stochastic depth over the point axis (JAX drop_path)."""
    return _drop(x, rate, training, rng, x.shape[:-1] + (1,))


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the valid points of the batch (eps 1e-3, momentum
    0.01 in the torch convention). Train mode normalises with the masked
    batch mean and biased variance and moves the running statistics
    towards the mean and the unbiased variance; eval mode uses the running
    statistics."""

    def __init__(self, features, eps=1e-3, momentum=0.01):
        super().__init__()
        self.eps, self.momentum = eps, momentum
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
            cnt = m.sum().clamp(min=1.0)
            mean = (xf * m).sum(0) / cnt
            var = (((xf - mean) ** 2) * m).sum(0) / cnt
            with torch.no_grad():
                unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
                self.running_mean.mul_(1 - self.momentum).add_(
                    self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * unbiased)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


class AdaptiveNorm(nn.Module):
    """The JAX AdaptiveNorm with adaptive=False: a base norm held as
    `.norm`, so parameter names match the flax tree. The point mask feeds
    only the batch norm's statistics."""

    def __init__(self, features, kind):
        super().__init__()
        self.kind = kind
        self.norm = MaskedBatchNorm(features) if kind == "bn" else \
            nn.LayerNorm(features, eps=1e-5)

    def forward(self, x, mask=None):
        return self.norm(x, mask) if self.kind == "bn" else self.norm(x)


class MLP(nn.Module):
    def __init__(self, cin, hidden, cout, generator, drop=0.0):
        super().__init__()
        self.drop = drop
        self.fc1 = dense(cin, hidden, generator)
        self.fc2 = dense(hidden, cout, generator)

    def forward(self, x, rng=None):
        x = dropout(gelu(self.fc1(x)), self.drop, self.training, rng)
        return dropout(self.fc2(x), self.drop, self.training, rng)


class SubMConv(nn.Module):
    """Submanifold sparse conv; weight (K, Cin, Cout) in stencil_offsets
    order, spconv-like uniform init over fan_in = K * Cin."""

    def __init__(self, cin, cout, kernel_size, generator, use_bias=True):
        super().__init__()
        K = kernel_size ** 3
        bound = math.sqrt(1.0 / (K * cin))
        self.weight = nn.Parameter(
            (torch.rand(K, cin, cout, generator=generator) * 2 - 1) * bound)
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x, nmap: NeighborMap):
        return subm_conv_apply(x, nmap, self.weight, self.bias)


class SerializedAttention(nn.Module):
    """Patch attention over one serialized order. The input is arranged in
    padded serialized order (a shift+select when the stream already lives
    in that order), projected to q/k/v, qk-normed (eps 1e-6) and attended
    per patch with fp32 softmax; masked keys get -1e9: K1 in eval mode,
    K5 (backward K6) with the attention-dropout rate in train mode."""

    def __init__(self, channels, num_heads, patch_size, generator,
                 order_index=0, qkv_bias=True, qk_scale=None, qk_norm=True,
                 attn_drop=0.0, proj_drop=0.0):
        super().__init__()
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.channels, self.num_heads = channels, num_heads
        self.patch_size, self.order_index = patch_size, order_index
        self.head_dim = channels // num_heads
        self.scale = qk_scale or self.head_dim ** -0.5
        self.qkv = dense(channels, 3 * channels, generator, bias=qkv_bias)
        self.qk_norm = qk_norm
        if qk_norm:
            self.q_norm = nn.LayerNorm(self.head_dim, eps=1e-6)
            self.k_norm = nn.LayerNorm(self.head_dim, eps=1e-6)
        self.proj = dense(channels, channels, generator)

    def forward(self, feat, aux, rng=None):
        B, N, C = feat.shape
        H, P, Dh = self.num_heads, self.patch_size, self.head_dim
        order = aux["order"][self.order_index]
        inverse = aux["inverse"][self.order_index]
        if order is None:
            feat = dup_pad_identity(feat, aux["counts"], P)
        else:
            feat = gather_sorted(feat, order, aux["src_pos"])
        NP = N // P
        q, k, v = (t.reshape(B, NP, P, H, Dh)
                   for t in self.qkv(feat).split(C, dim=-1))
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        # (B, NP, P, H, Dh) -> (B*NP, H, P, Dh): the JAX kernel layout
        qg, kg, vg = (t.permute(0, 1, 3, 2, 4).reshape(B * NP, H, P, Dh)
                      .contiguous() for t in (q, k, v))
        kv = aux["key_valid"].reshape(B * NP, P)
        if self.training:
            rate = self.attn_drop
            seed = rng.seed32() if rate > 0.0 else 0
            og = patch_attention_dropout(qg, kg, vg, kv, self.scale, rate,
                                         seed)
        else:
            og = patch_attention(qg, kg, vg, kv, self.scale)
        out = og.reshape(B, NP, H, P, Dh).permute(0, 1, 3, 2, 4)
        out = out.reshape(B, N, C)
        if inverse is not None:
            out = scatter_back(out.contiguous(), inverse)
        return dropout(self.proj(out), self.proj_drop, self.training, rng)


class CrossAttention(nn.Module):
    """Points -> text-token cross attention; masked tokens get -1e4."""

    def __init__(self, channels, num_heads, context_channels, generator,
                 qk_norm=True, attn_drop=0.0, proj_drop=0.0):
        super().__init__()
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.num_heads = num_heads
        self.head_dim = channels // num_heads
        self.q = dense(channels, channels, generator)
        self.kv = dense(context_channels, 2 * channels, generator)
        self.qk_norm = qk_norm
        if qk_norm:
            self.q_norm = nn.LayerNorm(self.head_dim, eps=1e-6)
            self.k_norm = nn.LayerNorm(self.head_dim, eps=1e-6)
        self.proj = dense(channels, channels, generator)

    def forward(self, feat, context, context_mask, rng=None):
        B, N, C = feat.shape
        T = context.shape[1]
        H, Dh = self.num_heads, self.head_dim
        q = self.q(feat).reshape(B, N, H, Dh)
        k, v = (t.reshape(B, T, H, Dh)
                for t in self.kv(context).split(C, dim=-1))
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        logits = torch.einsum("bnhd,bthd->bnth", q, k) * Dh ** -0.5
        logits = torch.where(context_mask[:, None, :, None], logits,
                             torch.full_like(logits, -1e4))
        attn = torch.softmax(logits.float(), dim=2)
        attn = dropout(attn, self.attn_drop, self.training, rng)
        out = torch.einsum("bnth,bthd->bnhd", attn.to(v.dtype), v)
        return dropout(self.proj(out.reshape(B, N, C)), self.proj_drop,
                       self.training, rng)


class Block(nn.Module):
    """PTv3 block: CPE conv residual (K2 conv -> linear -> LN), pre-norm
    patch attention, pre-norm MLP."""

    def __init__(self, channels, num_heads, patch_size, generator,
                 mlp_ratio=4.0, qkv_bias=True, qk_scale=None, qk_norm=True,
                 order_index=0, attn_drop=0.0, proj_drop=0.0, drop_path=0.0):
        super().__init__()
        self.drop_path = drop_path
        self.cpe_conv = SubMConv(channels, channels, 3, generator)
        self.cpe_fc = dense(channels, channels, generator)
        self.cpe_norm = AdaptiveNorm(channels, "ln")
        self.norm1 = AdaptiveNorm(channels, "ln")
        self.attn = SerializedAttention(
            channels, num_heads, patch_size, generator,
            order_index=order_index, qkv_bias=qkv_bias, qk_scale=qk_scale,
            qk_norm=qk_norm, attn_drop=attn_drop, proj_drop=proj_drop)
        self.norm2 = AdaptiveNorm(channels, "ln")
        self.mlp = MLP(channels, int(channels * mlp_ratio), channels,
                       generator, drop=proj_drop)

    def forward(self, feat, aux, cpe_feat=None, rng=None):
        """cpe_feat: the stale CPE input of the first decoder block after an
        unpool — the upstream SerializedUnpooling never refreshes the
        sparse-conv feature buffer, so that block's conv reads the bare
        proj_skip output (released checkpoints were trained that way)."""
        cpe = self.cpe_conv(feat if cpe_feat is None else cpe_feat,
                            aux["cpe_nmap"])
        feat = feat + self.cpe_norm(self.cpe_fc(cpe))
        x = self.attn(self.norm1(feat), aux, rng)
        feat = feat + drop_path(x, self.drop_path, self.training, rng)
        x = self.mlp(self.norm2(feat), rng)
        return feat + drop_path(x, self.drop_path, self.training, rng)


class CABlock(nn.Module):
    """Cross-attention block after each self-attention block (CA
    variant)."""

    def __init__(self, channels, num_heads, context_channels, generator,
                 mlp_ratio=4.0, qk_norm=True, attn_drop=0.0, proj_drop=0.0):
        super().__init__()
        self.norm1 = AdaptiveNorm(channels, "ln")
        self.attn = CrossAttention(channels, num_heads, context_channels,
                                   generator, qk_norm=qk_norm,
                                   attn_drop=attn_drop, proj_drop=proj_drop)
        self.norm2 = AdaptiveNorm(channels, "ln")
        self.mlp = MLP(channels, int(channels * mlp_ratio), channels,
                       generator, drop=proj_drop)

    def forward(self, feat, context, context_mask, rng=None):
        feat = feat + self.attn(self.norm1(feat), context, context_mask, rng)
        return feat + self.mlp(self.norm2(feat), rng)
