"""PointTransformerV3 U-Net backbone (port of
robot3dlotus_tpu/models/ptv3.py `PointTransformerV3TPU`), with the
conditioning of each variant: cross-attention blocks on text tokens
(use_cross_attn, the CA variant), norms modulated by a per-cloud context
vector (norm_adaptive, AdaNorm), or neither (Concat, whose context enters
with the stem's input). pdnorm_only_decoder means two things, as in the
JAX package: under CA the encoder's cross-attention blocks are left out
except at the last stage; otherwise the stem, the encoder poolings and the
encoder blocks' norms are plain except the last stage's blocks.

Clouds are fixed-capacity padded (B, N_s, C) tensors with masks; per-stage
capacities follow `_stage_caps`. The dataflow is sorted-resident: each
stage lives in the frame of its first SFC order, so depth-1 blocks need no
permutes (duplicate-padding is a shift+select), the CPE conv reads the
frame directly and pooling segments are contiguous runs. Per-point outputs
come back in the stage-0 sorted frame with `sort0` (frame position ->
input index). With shuffle_orders, train mode permutes the SFC orders at
stage 0 and after every pooling (Randomness.permutation) and re-sorts the
stage by its new first order through K4; an eval-mode forward shuffles
only when it is given a Randomness (the Actioner's ensembles). A
batch presorted on the host (TRAIN.host_structure,
train/datasets/structure.py) brings its `order_perm` instead: the codes
take that order, there is no stage-0 entry sort and no stage redraws.
Entry sorts go through permute_rows_any: K9 for the stage-0 input
features (at most 32 channels), K4 for the pooled stages. A categorical
stem input (the motion planner's point labels, `stem_categorical`) is
carried into the stage-0 frame by sort0 and feeds only the stem conv.
The TPU-only window/far-list inputs of the JAX backbone have no
counterpart.

compute_dtype ('bfloat16'; None, 'float32' or 'fp32' for fp32) is the JAX
backbone's: every Block, CABlock, pooling and unpooling computes in bf16
(models/layers.py says how), the stem conv casts its input and weight,
the stem's output (after its norm and GELU) and the context tokens are
cast to bf16, and the outputs (_pack) are fp32, so the heads, the decode
and the losses stay fp32. The parameters stay fp32.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.gather import permute_rows_any
from ..ops.patching import build_pad_maps
from ..ops.pooling import (build_pool_maps, gather_heads, segment_reduce,
                           take_rows, unpool_gather)
from ..ops.serialization import (SENTINEL, SFC_ORDERS, argsort_with_inverse,
                                 serialize_codes)
from ..ops.sparse_conv import build_neighbor_map
from .layers import (AdaptiveNorm, Block, CABlock, SubMConv, dense, gelu,
                     resolve_compute_dtype)


def compute_grid_coord(coord, mask, grid_size, depth):
    """floor((coord - per-cloud min) / grid_size), clipped to the cube.

    The divisor is a device tensor: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which moves points across voxel
    edges relative to the host presort and the JAX package. It is filled
    on the device (new_tensor would copy it from the host and synchronize
    the stream)."""
    big = torch.full_like(coord, 1e9)
    cmin = torch.where(mask[..., None], coord, big).amin(dim=1, keepdim=True)
    gc = torch.floor((coord - cmin) / torch.full(
        (), grid_size, dtype=coord.dtype, device=coord.device))
    gc = gc.to(torch.int32)
    return gc.clamp(0, (1 << depth) - 1)


class SerializedPooling(nn.Module):
    """Grid pooling: linear proj -> segment max -> BN -> GELU."""

    def __init__(self, cin, cout, generator, adaptive=False,
                 context_channels=256, dtype=None):
        super().__init__()
        self.proj = dense(cin, cout, generator, dtype=dtype)
        self.norm = AdaptiveNorm(cout, "bn", generator, adaptive,
                                 context_channels, dtype)

    def forward(self, feat_sorted, maps, child_cap, context_vec=None):
        x = segment_reduce(self.proj(feat_sorted), maps, child_cap, "max")
        return gelu(self.norm(x, maps.child_mask, context_vec))


class SerializedUnpooling(nn.Module):
    """proj(child)[cluster] + proj_skip(parent), each proj Linear -> BN ->
    GELU. Also returns the bare skip, which the next block's CPE reads."""

    def __init__(self, cin, cskip, cout, generator, adaptive=False,
                 context_channels=256, dtype=None):
        super().__init__()
        norm = (generator, adaptive, context_channels, dtype)
        self.proj_fc = dense(cin, cout, generator, dtype=dtype)
        self.proj_norm = AdaptiveNorm(cout, "bn", *norm)
        self.proj_skip_fc = dense(cskip, cout, generator, dtype=dtype)
        self.proj_skip_norm = AdaptiveNorm(cout, "bn", *norm)

    def forward(self, child_feat, child_mask, parent_feat, parent_mask,
                cluster, child_cap, context_vec=None):
        x = gelu(self.proj_norm(self.proj_fc(child_feat), child_mask,
                                context_vec))
        skip = gelu(self.proj_skip_norm(self.proj_skip_fc(parent_feat),
                                        parent_mask, context_vec))
        return skip + unpool_gather(x, cluster, child_cap), skip


class PointTransformerV3(nn.Module):
    def __init__(self, generator, context_channels=256, in_channels=7,
                 orders: Sequence[str] = SFC_ORDERS,
                 enc_depths=(1, 1, 1, 1, 1),
                 enc_channels=(64, 128, 256, 512, 768),
                 enc_num_head=(2, 4, 8, 16, 32),
                 enc_patch_size=(128, 128, 128, 128, 128),
                 dec_depths=(1, 1, 1, 1), dec_channels=(128, 128, 256, 512),
                 dec_num_head=(4, 4, 8, 16),
                 dec_patch_size=(128, 128, 128, 128), mlp_ratio=4.0,
                 qkv_bias=True, qk_scale=None, qk_norm=True, attn_drop=0.0,
                 proj_drop=0.0, drop_path=0.0, shuffle_orders=True,
                 grid_size=0.01, serial_depth=10,
                 stem_kernel=5, lookup_extent=128, assume_sorted=False,
                 stage_caps: Optional[Sequence[int]] = None,
                 stem_categorical_channels=0, use_cross_attn=True,
                 norm_adaptive=False, pdnorm_only_decoder=False,
                 compute_dtype=None, upcast_attention=False,
                 scaled_cosine_attn=False, enable_rpe=False,
                 add_coords_in_attn="none"):
        """in_channels: the stem's input width (under Concat the point
        features and the context vector); compute_dtype: None, 'float32',
        'fp32' or 'bfloat16'; upcast_attention, scaled_cosine_attn,
        enable_rpe, add_coords_in_attn: every Block's attention options
        (models/layers.py SerializedAttention)."""
        super().__init__()
        self.compute_dtype = dt = resolve_compute_dtype(compute_dtype)
        self.orders = tuple(orders)
        self.enc_depths, self.dec_depths = tuple(enc_depths), tuple(dec_depths)
        self.enc_channels = tuple(enc_channels)
        self.enc_patch_size = tuple(enc_patch_size)
        self.dec_patch_size = tuple(dec_patch_size)
        self.grid_size, self.serial_depth = grid_size, serial_depth
        self.stem_kernel, self.lookup_extent = stem_kernel, lookup_extent
        self.assume_sorted = assume_sorted
        self.shuffle_orders = shuffle_orders
        self.stage_caps = None if stage_caps is None else tuple(stage_caps)
        self.use_cross_attn = use_cross_attn
        S = len(enc_depths)
        # pdnorm_only_decoder: plain encoder norms (not under CA), or no
        # encoder cross-attention blocks (CA), except at the last stage
        only_dec_norms = pdnorm_only_decoder and not use_cross_attn
        enc_adaptive = norm_adaptive and not only_dec_norms
        self.enc_cablocks = [use_cross_attn and (
            not pdnorm_only_decoder or s == S - 1) for s in range(S)]
        ctx = dict(context_channels=context_channels)
        g = generator
        drop = dict(attn_drop=attn_drop, proj_drop=proj_drop)
        blk = dict(mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, qk_scale=qk_scale,
                   qk_norm=qk_norm, dtype=dt,
                   upcast_attention=upcast_attention,
                   scaled_cosine_attn=scaled_cosine_attn,
                   enable_rpe=enable_rpe,
                   add_coords_in_attn=add_coords_in_attn, **drop)
        cab = dict(mlp_ratio=mlp_ratio, qk_norm=qk_norm, dtype=dt, **drop)
        # drop-path rates rise linearly over the encoder blocks, and over
        # the decoder blocks, deepest first (JAX ptv3 _linspace)
        enc_dp = _linspace(0.0, drop_path, sum(enc_depths))
        dec_dp = _linspace(0.0, drop_path, sum(dec_depths))

        self.embedding_stem_conv = SubMConv(
            in_channels, enc_channels[0], stem_kernel, g, use_bias=False,
            categorical_channels=stem_categorical_channels, dtype=dt)
        self.embedding_norm = AdaptiveNorm(enc_channels[0], "bn", g,
                                           enc_adaptive, context_channels, dt)
        for s in range(S):
            if s > 0:
                self.add_module(f"enc{s}_down", SerializedPooling(
                    enc_channels[s - 1], enc_channels[s], g, enc_adaptive,
                    context_channels, dt))
            for i in range(enc_depths[s]):
                self.add_module(f"enc{s}_block{i}", Block(
                    enc_channels[s], enc_num_head[s],
                    self._block_patch(enc_patch_size[s], s), g,
                    order_index=i % len(self.orders),
                    drop_path=enc_dp[sum(enc_depths[:s]) + i],
                    norm_adaptive=norm_adaptive and (
                        not only_dec_norms or s == S - 1), **blk, **ctx))
                if self.enc_cablocks[s]:
                    self.add_module(f"enc{s}_cablock{i}", CABlock(
                        enc_channels[s], enc_num_head[s], context_channels,
                        g, **cab))
        dec_ch = list(dec_channels) + [enc_channels[-1]]
        for s in reversed(range(S - 1)):
            self.add_module(f"dec{s}_up", SerializedUnpooling(
                dec_ch[s + 1], enc_channels[s], dec_ch[s], g, norm_adaptive,
                context_channels, dt))
            dp = dec_dp[sum(dec_depths[:s]):sum(dec_depths[:s + 1])][::-1]
            for i in range(dec_depths[s]):
                self.add_module(f"dec{s}_block{i}", Block(
                    dec_ch[s], dec_num_head[s],
                    self._block_patch(dec_patch_size[s], s), g,
                    order_index=i % len(self.orders), drop_path=dp[i],
                    norm_adaptive=norm_adaptive, **blk, **ctx))
                if use_cross_attn:
                    self.add_module(f"dec{s}_cablock{i}", CABlock(
                        dec_ch[s], dec_num_head[s], context_channels, g,
                        **cab))

    def _block_patch(self, patch, s):
        """A block's patch, as the JAX backbone passes it: min(patch, stage
        capacity) where stage_caps gives the capacity (the attention takes
        min(patch, N) of the rows it is given in any case; the rpe table is
        sized by this one)."""
        if self.stage_caps is None:
            return patch
        return min(patch, int(self.stage_caps[s]))

    def _stage_caps(self, n0):
        if self.stage_caps is not None:
            base = [int(c) for c in self.stage_caps]
            assert len(base) == len(self.enc_depths)
            if n0 >= base[0]:
                return [min(base[0], n0)] + base[1:]
            # shrunken input capacity (eval point buckets): scale the audited
            # schedule, rounded up to a patch multiple
            mp = min(self.enc_patch_size)
            out = [n0]
            for c in base[1:]:
                scaled = -(-c * n0 // base[0])
                scaled = -(-scaled // mp) * mp
                out.append(max(min(scaled, c), min(mp, n0)))
            return out
        caps = [n0]
        for _ in range(1, len(self.enc_depths)):
            caps.append(max(caps[-1] // 2, min(self.enc_patch_size)))
        return caps

    def _used_order_indices(self, s):
        n = len(self.orders)
        used = {i % n for i in range(self.enc_depths[s])}
        if s < len(self.dec_depths):
            used |= {i % n for i in range(self.dec_depths[s])}
        return sorted(used | {0})

    def _make_aux(self, cur, s, patch):
        codes, counts, cap = cur["codes"], cur["counts"], cur["cap"]
        order = [None] * len(self.orders)
        inverse = [None] * len(self.orders)
        for i in self._used_order_indices(s):
            if i:
                order[i], inverse[i] = argsort_with_inverse(codes[i])
        src_pos, key_valid = build_pad_maps(counts, cap, min(patch, cap))
        cpe_nmap = build_neighbor_map(cur["grid_coord"], cur["mask"], 3,
                                      cur["depth"], extent=self.lookup_extent)
        return {"order": order, "inverse": inverse, "src_pos": src_pos,
                "key_valid": key_valid, "cpe_nmap": cpe_nmap,
                "counts": counts, "grid_coord": cur["grid_coord"],
                "coord": cur["coord"]}

    def _entry_sort(self, cur):
        """Sort every per-point array by codes[0] (stable; the sentinel
        tail last); features go through K9 (<= 32 channels) or K4."""
        order = torch.argsort(cur["codes"][0], dim=-1, stable=True)
        new = dict(cur)
        new["feat"] = permute_rows_any(cur["feat"].contiguous(), order)
        new["coord"] = take_rows(cur["coord"], order)
        new["grid_coord"] = take_rows(cur["grid_coord"], order)
        new["codes"] = torch.gather(cur["codes"], -1, order[None].expand_as(
            cur["codes"]))
        new["mask"] = torch.arange(cur["cap"], device=order.device)[None] < \
            cur["counts"][:, None]
        return new, order

    def forward(self, coord, feat, mask, counts, context=None,
                context_mask=None, rng=None, stem_categorical=None,
                order_perm=None, context_vec=None):
        """coord (B, N, 3); feat (B, N, Cin); mask (B, N) bool; counts (B,);
        context (B, T, C) tokens, context_mask (B, T): the CA variant's;
        context_vec (B, C): the adaptive norms'; rng: the Randomness of a
        train-mode forward (or of a shuffled eval-mode one);
        stem_categorical: None, or (idx (B, N)
        int, table (Kcat, E)) appended to feat for the stem conv only;
        order_perm: None, or the (num_orders,) order permutation the host
        chose, the inputs already sorted by its first order's code.
        Returns the list of decoder layer outputs, outputs[0] carrying
        sort0 and pool_overflow."""
        S = len(self.enc_depths)
        B, N0, _ = feat.shape
        caps = self._stage_caps(N0)
        depth0 = self.serial_depth
        counts = counts.long()
        grid_coord = compute_grid_coord(coord, mask, self.grid_size, depth0)
        codes = serialize_codes(grid_coord, mask, depth0, self.orders)
        shuffle = self.shuffle_orders and order_perm is None and (
            self.training or rng is not None)
        if shuffle:
            codes = self._shuffled(codes, rng)
        elif order_perm is not None:
            codes = codes[torch.as_tensor(order_perm, device=codes.device)
                          .long()]
        cur = {"feat": feat, "coord": coord, "grid_coord": grid_coord,
               "mask": mask, "counts": counts, "codes": codes,
               "depth": depth0, "cap": N0}
        if (self.assume_sorted or order_perm is not None) and not shuffle:
            sort0 = torch.arange(N0, device=feat.device).expand(B, N0)
        else:
            cur, sort0 = self._entry_sort(cur)
            if stem_categorical is not None:
                stem_categorical = (take_rows(stem_categorical[0], sort0),
                                    stem_categorical[1])

        stem_map = build_neighbor_map(cur["grid_coord"], cur["mask"],
                                      self.stem_kernel, depth0,
                                      extent=self.lookup_extent)
        x = self.embedding_stem_conv(cur["feat"].contiguous(), stem_map,
                                     categorical=stem_categorical)
        cur["feat"] = gelu(self.embedding_norm(x, cur["mask"], context_vec))
        if self.compute_dtype is not None:
            cur["feat"] = cur["feat"].to(self.compute_dtype)
            if context is not None:
                context = context.to(self.compute_dtype)

        pool_overflow = torch.zeros((), dtype=torch.long, device=feat.device)
        stage_state, pool_records = [], []
        for s in range(S):
            if s > 0:
                cur, record, overflow = self._pool(s, cur, caps[s], shuffle,
                                                   rng, context_vec)
                pool_overflow = pool_overflow + overflow
                pool_records.append(record)
            aux = self._make_aux(cur, s, self.enc_patch_size[s])
            cur["aux"] = aux
            for i in range(self.enc_depths[s]):
                cur["feat"] = getattr(self, f"enc{s}_block{i}")(
                    cur["feat"], aux, rng=rng, context_vec=context_vec)
                if self.enc_cablocks[s]:
                    cur["feat"] = getattr(self, f"enc{s}_cablock{i}")(
                        cur["feat"], context, context_mask, rng)
            stage_state.append(dict(cur))

        outputs = [self._pack(cur)]
        outputs[0]["sort0"] = sort0
        outputs[0]["pool_overflow"] = pool_overflow
        for s in reversed(range(S - 1)):
            parent = stage_state[s]
            cluster, child_cap = pool_records[s]
            feat_s, skip_s = getattr(self, f"dec{s}_up")(
                cur["feat"], cur["mask"], parent["feat"], parent["mask"],
                cluster, child_cap, context_vec)
            cur = dict(parent)
            cur["feat"] = feat_s
            aux = parent["aux"]
            for i in range(self.dec_depths[s]):
                cur["feat"] = getattr(self, f"dec{s}_block{i}")(
                    cur["feat"], aux, skip_s if i == 0 else None, rng,
                    context_vec)
                if self.use_cross_attn:
                    cur["feat"] = getattr(self, f"dec{s}_cablock{i}")(
                        cur["feat"], context, context_mask, rng)
                outputs.append(self._pack(cur))
        return outputs

    def _shuffled(self, codes, rng):
        perm = torch.as_tensor(rng.permutation(codes.shape[0]),
                               device=codes.device)
        return codes[perm]

    def _pool(self, s, cur, child_cap, shuffle, rng, context_vec=None):
        """Grid pooling in the sorted-resident frame. Children come out in
        (parent code >> 3) order, which stays ascending, so an unshuffled
        child stage needs no entry sort; a shuffled one is re-sorted by its
        new first order and the unpooling clusters are remapped into that
        frame. Segments beyond child_cap drop their geometry and are
        counted in pool_overflow."""
        codes = cur["codes"]
        maps = build_pool_maps(codes[0], cur["counts"], child_cap)
        new_feat = getattr(self, f"enc{s}_down")(cur["feat"], maps,
                                                 child_cap, context_vec)
        new_coord = segment_reduce(cur["coord"], maps, child_cap, "mean")
        new_gc = gather_heads(cur["grid_coord"], maps) >> 1
        new_codes = torch.stack([gather_heads(codes[k], maps) >> 3
                                 for k in range(codes.shape[0])])
        new_codes = torch.where(maps.child_mask[None], new_codes,
                                torch.full_like(new_codes, SENTINEL))
        if shuffle:
            new_codes = self._shuffled(new_codes, rng)
        overflow = torch.clamp(maps.child_counts - child_cap, min=0).sum()
        new_cur = {
            "feat": new_feat, "coord": new_coord, "grid_coord": new_gc,
            "mask": maps.child_mask,
            "counts": torch.clamp(maps.child_counts, max=child_cap),
            "codes": new_codes, "depth": max(cur["depth"] - 1, 1),
            "cap": child_cap,
        }
        cluster = maps.seg_sorted
        if shuffle:
            new_cur, o_child = self._entry_sort(new_cur)
            # segment ids -> child frame positions; the drop slot
            # (child_cap) stays K4's sentinel
            inv = torch.argsort(o_child, dim=-1)
            inv = torch.cat([inv, torch.full_like(inv[:, :1], child_cap)], 1)
            cluster = torch.gather(inv, 1, cluster)
        return new_cur, (cluster, child_cap), overflow

    @staticmethod
    def _pack(cur):
        # the heads and losses take fp32 whatever the compute dtype
        return {"feat": cur["feat"].float(), "coord": cur["coord"],
                "mask": cur["mask"], "counts": cur["counts"]}


def _linspace(a, b, n):
    if n <= 1:
        return [b] * n
    return [a + (b - a) * i / (n - 1) for i in range(n)]
