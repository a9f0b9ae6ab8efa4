"""PyTorch port vs the JAX package: K1 (patch attention) and K3 (the stem
conv) at the release serving shapes, and the plans their CUDA kernels run.

- K1's plain version (its wrapper's CPU path and the oracle of
  csrc/attention.cu) against the JAX `patch_attention` (Pallas in interpret
  mode) and its exact XLA path, at the release B = 1 calls (stage 0:
  (32, 2, 128, 32); stage 4: (2, 32, 128, 24)), a ragged P = 37 and a
  patch with no valid key, 1e-4 absolute.
- K3's plain version against the JAX windowed stem gather
  (`stem_gather_windowed`, interpret mode, with its far links) followed by
  the stencil product, and against the exact XLA conv, on a 4096-point
  cloud (Cin 7, Cout 64), 1e-4 absolute.
- K1's query split (attention_query_split) and K3's tile / tap-range plan
  (stem_conv_plan, stem_tap_ranges), enumerated block by block in numpy as
  the kernels walk them: every (patch, head, query row) and every (row,
  channel, tap) covered exactly once and in order, and the B = 1 release
  calls launching about one block per SM of the H100 (128 of its 132)
  where the work has that many, in the largest blocks that do.
- chip_smoke's stem work shares against a numpy count.
The kernels themselves run on the card: test_torch_port_gpu.py.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from chip_smoke import stem_shares
from robot3dlotus_tpu.ops import pallas_attention as jattn
from robot3dlotus_tpu.ops import pallas_stem as jstem
from robot3dlotus_tpu.ops.sparse_conv import (build_neighbor_map,
                                              subm_conv_apply)
from robot3dlotus_tpu_torch.ops import attention, stem
from robot3dlotus_tpu_torch.ops.sfc_np import z_order_encode_np

ATOL = 1e-4
# the release policy's B = 1 attention calls (G, H, P, Dh): encoder
# stages 0-4, decoder stages 3-0 (simple_policy_ptv3.yaml)
RELEASE_B1 = [(32, 2, 128, 32), (18, 4, 128, 32), (8, 8, 128, 32),
              (4, 16, 128, 32), (2, 32, 128, 24), (4, 16, 128, 32),
              (8, 8, 128, 32), (18, 4, 128, 32), (32, 4, 128, 32)]


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("G,H,P,Dh", [(32, 2, 128, 32), (2, 32, 128, 24),
                                      (6, 3, 37, 16), (4, 2, 37, 8)])
def test_k1_plain_matches_jax_at_release_shapes(G, H, P, Dh):
    rng = np.random.RandomState(G * P + Dh)
    q, k, v = (rng.randn(G, H, P, Dh).astype(np.float32) for _ in range(3))
    kv = rng.rand(G, P) > 0.2
    kv[1] = False                  # no valid key: uniform weights
    scale = Dh ** -0.5
    got = attention.patch_attention(T(q), T(k), T(v), T(kv), scale).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[1], np.broadcast_to(
        v[1].mean(1, keepdims=True), (H, P, Dh)), atol=ATOL, rtol=0)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv))
    pallas = jattn.patch_attention(*jargs, scale, True)
    xla = jattn._xla_reference(*jargs, scale)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(xla), atol=ATOL, rtol=0)


def _release_cloud(rng, n=4096):
    """A tabletop cloud of n distinct 1 cm voxels (a table, a box, a
    cylinder), its rows in z-order as the serialized stage-0 frame has
    them."""
    table = np.stack(np.meshgrid(np.arange(96), np.arange(96), [0],
                                 indexing="ij"), -1).reshape(-1, 3)
    box = np.stack(np.meshgrid(np.arange(30, 46), np.arange(40, 56),
                               np.arange(1, 17), indexing="ij"),
                   -1).reshape(-1, 3)
    box = box[(box.min(1) == 1) | (box[:, 0] % 15 == 0) |
              (box[:, 1] % 55 == 0) | (box[:, 2] == 16) |
              (box[:, 1] == 40) | (box[:, 0] == 45)]
    t = np.linspace(0, 2 * np.pi, 40, endpoint=False)
    cyl = np.stack([70 + np.round(6 * np.cos(t)),
                    20 + np.round(6 * np.sin(t))], -1).astype(int)
    cyl = np.concatenate([np.concatenate([cyl, np.full((40, 1), z)], 1)
                          for z in range(1, 25)])
    pts = np.unique(np.concatenate([table, box, cyl]), axis=0)
    pts = pts[rng.choice(len(pts), n, replace=False)]
    return pts[np.argsort(z_order_encode_np(pts, 7), kind="stable")]


def test_k3_plain_matches_jax_on_a_release_cloud():
    """stem_conv_plain against the JAX windowed stem gather (near links in
    the Pallas kernel, in interpret mode, the links outside its window
    through its far lists, none dropped) followed by the stencil product,
    and against the exact XLA conv; 4096 points, Cin 7, Cout 64."""
    rng = np.random.RandomState(7)
    gc = _release_cloud(rng)[None].astype(np.int32)
    mask = np.ones((1, 4096), bool)
    nm = build_neighbor_map(jnp.asarray(gc), jnp.asarray(mask), 5, 7,
                            extent=128)
    ok = np.asarray(nm.ok)
    assert 0.02 < ok.mean() < 0.3          # sparse, as a release cloud is
    feat = rng.randn(1, 4096, 7).astype(np.float32)
    w = (rng.randn(125, 7, 64) * 0.1).astype(np.float32)
    got = stem.stem_conv_plain(T(feat), T(np.asarray(nm.idx)), T(ok),
                               T(w)).numpy()
    g, far = jstem.stem_gather_windowed(jnp.asarray(feat), nm,
                                        interpret=True, far_per_tap=4096)
    rows, far_dst, far_ok, dropped = far
    assert int(dropped.sum()) == 0 and bool(far_ok.any())
    g = jnp.where(nm.ok[..., None], g, 0.0)
    windowed = jnp.einsum("bnkc,kcd->bnd", g, jnp.asarray(w))
    fc = jnp.einsum("bkfc,kcd->bkfd", jnp.where(far_ok[..., None], rows, 0.0),
                    jnp.asarray(w))
    windowed = windowed.at[0, far_dst.reshape(-1)].add(fc.reshape(-1, 64))
    xla = subm_conv_apply(jnp.asarray(feat), nm, jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(windowed), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(xla), atol=ATOL, rtol=0)


def _k1_rows(G, H, P, warps, splits):
    """(patch-head, query row) in the order K1's blocks write them: block
    b = (g H + h) splits + s, warp w, rows 16 (warps s + w) .. + 15 below
    P."""
    out = []
    for b in range(G * H * splits):
        gh, s = divmod(b, splits)
        for w in range(warps):
            r0 = 16 * (warps * s + w)
            out += [(gh, r) for r in range(r0, min(r0 + 16, P))]
    return out


@pytest.mark.parametrize("G,H,P", [(G, H, P) for G, H, P, _ in RELEASE_B1] +
                         [(128, 2, 128), (256, 8, 128), (1, 2, 37),
                          (6, 3, 48), (3, 1, 1), (64, 16, 100)])
def test_k1_query_split_covers_every_row_once(G, H, P):
    warps, splits = attention.attention_query_split(G, H, P)
    assert 1 <= warps <= attention.ATTN_MAX_WARPS
    assert _k1_rows(G, H, P, warps, splits) == \
        [(gh, r) for gh in range(G * H) for r in range(P)]
    # no block whose warps all lie past P
    assert 16 * warps * (splits - 1) < P
    blocks = G * H * splits
    most = G * H * -(-P // 16)             # one warp a block
    target = attention.ATTN_TARGET_BLOCKS
    assert blocks >= min(target, most)
    # the largest such block: twice its warps would launch too few
    wider = 2 * warps
    if wider <= min(8, -(-P // 16)):
        assert G * H * -(-(-(-P // 16)) // wider) < target


def test_k1_release_calls_fill_the_card():
    """Every B = 1 release call launches about one block per SM (the
    first design launched G H = 64-72 blocks of one patch each): stage 0
    runs 128 blocks of 4 warps."""
    for G, H, P, _ in RELEASE_B1:
        _, splits = attention.attention_query_split(G, H, P)
        assert G * H * splits >= attention.ATTN_TARGET_BLOCKS
    assert attention.attention_query_split(32, 2, 128) == (4, 2)


def _k3_coverage(B, N, K, cout, cols, warps, splits, blocks):
    """Visits of each (flat row, column tile, tap) by K3's blocks: block
    (x, y, s) warp w takes the 16-row groups x warps + w + i blocks warps
    of the B N rows, columns [cols y, cols (y + 1)) and tap range s; and
    the taps in the order the ranges hold them."""
    rows = B * N
    groups = -(-rows // 16)
    col_tiles = -(-cout // cols)
    ranges = stem.stem_tap_ranges(K, splits)
    count = np.zeros((rows, col_tiles, K), np.int32)
    for x in range(blocks):
        for w in range(warps):
            for g in range(x * warps + w, groups, blocks * warps):
                for y in range(col_tiles):
                    for kb, ke in ranges:
                        count[16 * g:16 * (g + 1), y, kb:ke] += 1
    order = [t for kb, ke in ranges for t in range(kb, ke)]
    return count, order


@pytest.mark.parametrize("B,N,K,cin,cout", [
    (1, 4096, 125, 7, 64), (4, 4096, 125, 7, 64), (32, 4096, 125, 7, 64),
    (32, 4096, 125, 8, 64), (2, 1000, 125, 7, 68), (1, 100, 125, 7, 48),
    (3, 50, 27, 8, 8)])
def test_k3_plan_covers_every_row_channel_tap_once(B, N, K, cin, cout):
    cols, warps, splits, blocks = stem.stem_conv_plan(B, N, K, cin, cout)
    sums = stem.stem_sum_ranges(K)
    assert 1 <= warps <= stem.STEM_MAX_WARPS and splits in (1, len(sums))
    assert stem.stem_smem_bytes(K, cin, cols, splits) <= stem.STEM_MAX_SMEM
    count, order = _k3_coverage(B, N, K, cout, cols, warps, splits, blocks)
    assert (count == 1).all()
    assert order == list(range(K))          # ranges ascend and abut
    ranges = stem.stem_tap_ranges(K, splits)
    assert all(kb < ke for kb, ke in ranges)   # no empty range
    assert all(kb % stem.STEM_RANGE_TAPS == 0 for kb, _ in ranges)
    assert ranges in ([(0, K)], sums)
    groups = -(-B * N // 16)
    # one block per sum range, or one per SM whose warps take 2+ groups
    assert splits == len(sums) or blocks * warps * 2 <= groups


def test_k3_release_plans():
    """B = 1 serving: 16 blocks of 16 warps, the taps in the 8 sum ranges
    of 16 (two launches, 128 blocks); B = 4 (predict_batch): the same 8
    ranges; the B = 32 training call: one 16-warp block per SM holding all
    125 taps' weight (219 KB), each warp taking about 4 row groups and
    summing the 8 ranges itself."""
    assert stem.stem_conv_plan(1, 4096, 125, 7, 64) == (64, 16, 8, 16)
    assert stem.stem_conv_plan(4, 4096, 125, 7, 64) == (64, 16, 8, 64)
    assert stem.stem_conv_plan(32, 4096, 125, 7, 64) == (64, 16, 1, 132)
    assert stem.stem_smem_bytes(125, 7, 64, 1) == 224000
    assert stem.stem_tap_ranges(125, 8) == [
        (0, 16), (16, 32), (32, 48), (48, 64), (64, 80), (80, 96),
        (96, 112), (112, 125)]


def test_stem_shares_match_a_numpy_count():
    rng = np.random.RandomState(3)
    B, N, K = 2, 100, 125
    ok = rng.rand(B, N, K) < 0.05
    ok[:, 32:48] = False                   # one dead 16-row group
    got = stem_shares(torch.from_numpy(ok))
    live = kept = groups = 0
    for b in range(B):
        for g0 in range(0, N, 16):
            for k in range(K):
                groups += 1
                rows = ok[b, g0:g0 + 16, k]
                live += int(rows.sum())
                kept += int(rows.any())
    assert got["live"] == pytest.approx(live / (B * N * K))
    assert got["group_kept"] == pytest.approx(kept / groups)
    assert got["group_kept"] > got["live"]
