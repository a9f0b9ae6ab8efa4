"""PointTransformerV3 U-Net backbone, CA variant, eval path (port of
robot3dlotus_tpu/models/ptv3.py `PointTransformerV3TPU`).

Clouds are fixed-capacity padded (B, N_s, C) tensors with masks; per-stage
capacities follow `_stage_caps`. The dataflow is sorted-resident: each
stage lives in the frame of its first SFC order, so depth-1 blocks need no
permutes (duplicate-padding is a shift+select), the CPE conv reads the
frame directly and pooling segments are contiguous runs. Per-point outputs
come back in the stage-0 sorted frame with `sort0` (frame position ->
input index). Orders are never shuffled here (deterministic eval); the
TPU-only window/far-list inputs of the JAX backbone have no counterpart.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.gather import gather_rows
from ..ops.patching import build_pad_maps
from ..ops.pooling import (build_pool_maps, gather_heads, segment_reduce,
                           take_rows, unpool_gather)
from ..ops.serialization import (SENTINEL, SFC_ORDERS, argsort_with_inverse,
                                 serialize_codes)
from ..ops.sparse_conv import build_neighbor_map
from .layers import AdaptiveNorm, Block, CABlock, SubMConv, dense, gelu


def compute_grid_coord(coord, mask, grid_size, depth):
    """floor((coord - per-cloud min) / grid_size), clipped to the cube.

    The divisor is a device tensor: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which moves points across voxel
    edges relative to the host presort and the JAX package."""
    big = torch.full_like(coord, 1e9)
    cmin = torch.where(mask[..., None], coord, big).amin(dim=1, keepdim=True)
    gc = torch.floor((coord - cmin) / coord.new_tensor(grid_size))
    gc = gc.to(torch.int32)
    return gc.clamp(0, (1 << depth) - 1)


class SerializedPooling(nn.Module):
    """Grid pooling: linear proj -> segment max -> BN -> GELU."""

    def __init__(self, cin, cout, generator):
        super().__init__()
        self.proj = dense(cin, cout, generator)
        self.norm = AdaptiveNorm(cout, "bn")

    def forward(self, feat_sorted, maps, child_cap):
        x = segment_reduce(self.proj(feat_sorted), maps, child_cap, "max")
        return gelu(self.norm(x))


class SerializedUnpooling(nn.Module):
    """proj(child)[cluster] + proj_skip(parent), each proj Linear -> BN ->
    GELU. Also returns the bare skip, which the next block's CPE reads."""

    def __init__(self, cin, cskip, cout, generator):
        super().__init__()
        self.proj_fc = dense(cin, cout, generator)
        self.proj_norm = AdaptiveNorm(cout, "bn")
        self.proj_skip_fc = dense(cskip, cout, generator)
        self.proj_skip_norm = AdaptiveNorm(cout, "bn")

    def forward(self, child_feat, parent_feat, cluster, child_cap):
        x = gelu(self.proj_norm(self.proj_fc(child_feat)))
        skip = gelu(self.proj_skip_norm(self.proj_skip_fc(parent_feat)))
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
                 qkv_bias=True, qk_scale=None, qk_norm=True,
                 grid_size=0.01, serial_depth=10,
                 stem_kernel=5, lookup_extent=128, assume_sorted=False,
                 stage_caps: Optional[Sequence[int]] = None):
        super().__init__()
        self.orders = tuple(orders)
        self.enc_depths, self.dec_depths = tuple(enc_depths), tuple(dec_depths)
        self.enc_channels = tuple(enc_channels)
        self.enc_patch_size = tuple(enc_patch_size)
        self.dec_patch_size = tuple(dec_patch_size)
        self.grid_size, self.serial_depth = grid_size, serial_depth
        self.stem_kernel, self.lookup_extent = stem_kernel, lookup_extent
        self.assume_sorted = assume_sorted
        self.stage_caps = None if stage_caps is None else tuple(stage_caps)
        S = len(enc_depths)
        g = generator
        blk = dict(mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, qk_scale=qk_scale,
                   qk_norm=qk_norm)
        cab = dict(mlp_ratio=mlp_ratio, qk_norm=qk_norm)

        self.embedding_stem_conv = SubMConv(in_channels, enc_channels[0],
                                            stem_kernel, g, use_bias=False)
        self.embedding_norm = AdaptiveNorm(enc_channels[0], "bn")
        for s in range(S):
            if s > 0:
                self.add_module(f"enc{s}_down", SerializedPooling(
                    enc_channels[s - 1], enc_channels[s], g))
            for i in range(enc_depths[s]):
                self.add_module(f"enc{s}_block{i}", Block(
                    enc_channels[s], enc_num_head[s], enc_patch_size[s], g,
                    order_index=i % len(self.orders), **blk))
                self.add_module(f"enc{s}_cablock{i}", CABlock(
                    enc_channels[s], enc_num_head[s], context_channels, g,
                    **cab))
        dec_ch = list(dec_channels) + [enc_channels[-1]]
        for s in reversed(range(S - 1)):
            self.add_module(f"dec{s}_up", SerializedUnpooling(
                dec_ch[s + 1], enc_channels[s], dec_ch[s], g))
            for i in range(dec_depths[s]):
                self.add_module(f"dec{s}_block{i}", Block(
                    dec_ch[s], dec_num_head[s], dec_patch_size[s], g,
                    order_index=i % len(self.orders), **blk))
                self.add_module(f"dec{s}_cablock{i}", CABlock(
                    dec_ch[s], dec_num_head[s], context_channels, g,
                    **cab))

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
                "counts": counts}

    def _entry_sort(self, cur):
        """Sort every per-point array by codes[0] (stable; the sentinel
        tail last); features go through K4."""
        order = torch.argsort(cur["codes"][0], dim=-1, stable=True)
        new = dict(cur)
        new["feat"] = gather_rows(cur["feat"].contiguous(), order)
        new["coord"] = take_rows(cur["coord"], order)
        new["grid_coord"] = take_rows(cur["grid_coord"], order)
        new["codes"] = torch.gather(cur["codes"], -1, order[None].expand_as(
            cur["codes"]))
        new["mask"] = torch.arange(cur["cap"], device=order.device)[None] < \
            cur["counts"][:, None]
        return new, order

    def forward(self, coord, feat, mask, counts, context, context_mask):
        """coord (B, N, 3); feat (B, N, Cin); mask (B, N) bool; counts (B,);
        context (B, T, C) tokens, context_mask (B, T). Returns the list of
        decoder layer outputs, outputs[0] carrying sort0 and
        pool_overflow."""
        S = len(self.enc_depths)
        B, N0, _ = feat.shape
        caps = self._stage_caps(N0)
        depth0 = self.serial_depth
        counts = counts.long()
        grid_coord = compute_grid_coord(coord, mask, self.grid_size, depth0)
        codes = serialize_codes(grid_coord, mask, depth0, self.orders)
        cur = {"feat": feat, "coord": coord, "grid_coord": grid_coord,
               "mask": mask, "counts": counts, "codes": codes,
               "depth": depth0, "cap": N0}
        if self.assume_sorted:
            sort0 = torch.arange(N0, device=feat.device).expand(B, N0)
        else:
            cur, sort0 = self._entry_sort(cur)

        stem_map = build_neighbor_map(cur["grid_coord"], cur["mask"],
                                      self.stem_kernel, depth0,
                                      extent=self.lookup_extent)
        x = self.embedding_stem_conv(cur["feat"].contiguous(), stem_map)
        cur["feat"] = gelu(self.embedding_norm(x))

        pool_overflow = torch.zeros((), dtype=torch.long, device=feat.device)
        stage_state, pool_records = [], []
        for s in range(S):
            if s > 0:
                cur, record, overflow = self._pool(s, cur, caps[s])
                pool_overflow = pool_overflow + overflow
                pool_records.append(record)
            aux = self._make_aux(cur, s, self.enc_patch_size[s])
            cur["aux"] = aux
            for i in range(self.enc_depths[s]):
                cur["feat"] = getattr(self, f"enc{s}_block{i}")(
                    cur["feat"], aux)
                cur["feat"] = getattr(self, f"enc{s}_cablock{i}")(
                    cur["feat"], context, context_mask)
            stage_state.append(dict(cur))

        outputs = [self._pack(cur)]
        outputs[0]["sort0"] = sort0
        outputs[0]["pool_overflow"] = pool_overflow
        for s in reversed(range(S - 1)):
            parent = stage_state[s]
            cluster, child_cap = pool_records[s]
            feat_s, skip_s = getattr(self, f"dec{s}_up")(
                cur["feat"], parent["feat"], cluster, child_cap)
            cur = dict(parent)
            cur["feat"] = feat_s
            aux = parent["aux"]
            for i in range(self.dec_depths[s]):
                cur["feat"] = getattr(self, f"dec{s}_block{i}")(
                    cur["feat"], aux, skip_s if i == 0 else None)
                cur["feat"] = getattr(self, f"dec{s}_cablock{i}")(
                    cur["feat"], context, context_mask)
                outputs.append(self._pack(cur))
        return outputs

    def _pool(self, s, cur, child_cap):
        """Grid pooling in the sorted-resident frame. Children come out in
        (parent code >> 3) order, which stays ascending, so the child stage
        needs no entry sort. Segments beyond child_cap drop their geometry
        and are counted in pool_overflow."""
        codes = cur["codes"]
        maps = build_pool_maps(codes[0], cur["counts"], child_cap)
        new_feat = getattr(self, f"enc{s}_down")(cur["feat"], maps,
                                                 child_cap)
        new_coord = segment_reduce(cur["coord"], maps, child_cap, "mean")
        new_gc = gather_heads(cur["grid_coord"], maps) >> 1
        new_codes = torch.stack([gather_heads(codes[k], maps) >> 3
                                 for k in range(codes.shape[0])])
        new_codes = torch.where(maps.child_mask[None], new_codes,
                                torch.full_like(new_codes, SENTINEL))
        overflow = torch.clamp(maps.child_counts - child_cap, min=0).sum()
        new_cur = {
            "feat": new_feat, "coord": new_coord, "grid_coord": new_gc,
            "mask": maps.child_mask,
            "counts": torch.clamp(maps.child_counts, max=child_cap),
            "codes": new_codes, "depth": max(cur["depth"] - 1, 1),
            "cap": child_cap,
        }
        return new_cur, (maps.seg_sorted, child_cap), overflow

    @staticmethod
    def _pack(cur):
        return {"feat": cur["feat"], "coord": cur["coord"],
                "mask": cur["mask"], "counts": cur["counts"]}
