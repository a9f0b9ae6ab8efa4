"""K1 with the relative-position bias (csrc/attention_opts.cuh), emulated in
numpy on the CPU: its bias warps write the bias of each math warp's query
rows into shared memory as the products' C fragments (a float4 a lane and
8-key tile: rows gr, gr + 8 by keys 2t, 2t + 1), and the math warps read
it back in attention_tile.cuh's softmax_rows. The emulation holds that
  - attention_opts_plan takes the bias-warp plan at B = 1's grids and
    the inline plan (the math lanes look the bias up) at larger ones;
  - under the bias-warp plan's split (at most OPTS_MAX_WARPS math warps a
    block) every logit of every patch below P is written once and read
    once, at the (row, key) it belongs to, at fp32 (key tiles up to P
    rounded to 8) and at bf16 (16-key blocks);
  - the clipped lookup on byte offsets that both plans make (one
    add-and-min with a floor at 0, the table's axes 32 floats apart)
    reads the table rows rpe_bias reads, and the sum (tx + ty) + tz is
    rpe_bias's fp32 value bit for bit;
  - k, v, the coordinates, the table and the tiles fit two blocks an SM.
"""
import numpy as np
import pytest
import torch

from robot3dlotus_tpu_torch.ops import attention

KMAXP = 128
AXIS_STRIDE = 32            # attention_opts.cuh kAxisStride
TABLE_SMEM = 96             # attention_tile.cuh kTableSmem (floats)
SMEM_PER_SM = 233472        # the H100's shared memory an SM (228 KB)
SMEM_RESERVED = 1024        # the runtime's share of each block


def _plan(G, H, P):
    """The bias-warp plan's (warps, splits)."""
    return attention.attention_query_split(G, H, P,
                                           attention.OPTS_MAX_WARPS)


RELEASE_B1 = [(32, 2), (18, 4), (8, 8), (4, 16), (2, 32), (32, 4)]


def test_plan_by_grid():
    """B = 1's calls take the bias-warp plan (a block of 4 math warps an
    SM, 128-144 blocks), B = 4's and B = 32's (stage 0: 1024 patches x 2
    heads) the inline plan with attention_query_split's block."""
    for G, H in RELEASE_B1:
        warps, splits, tile = attention.attention_opts_plan(G, H, 128)
        assert tile and warps == attention.OPTS_MAX_WARPS
        assert G * H * splits <= attention.OPTS_TILE_MAX_BLOCKS
        assert G * H * splits >= attention.ATTN_TARGET_BLOCKS
    for B in (4, 32):
        for G, H in RELEASE_B1:
            plan = attention.attention_opts_plan(B * G, H, 128)
            assert plan == (*attention.attention_query_split(B * G, H, 128),
                            False)
    assert attention.attention_opts_plan(1024, 2, 128) == (8, 1, False)


def _tile_entries(P, row0, kall):
    """{(n, lane, e): (row, key)} a bias lane writes for math warp rows
    row0.. (write_bias_tile)."""
    nt = ((P + 7) & ~7) >> 3
    out = {}
    for lane in range(32):
        gr, t = lane >> 2, lane & 3
        for n in range(KMAXP // 8):
            if kall or n < nt:
                for e, (dr, dk) in enumerate(((0, 0), (0, 1), (8, 0),
                                              (8, 1))):
                    out[(n, lane, e)] = (row0 + gr + dr, 8 * n + 2 * t + dk)
    return out


def _reads(P, row0, bf16):
    """[(n, lane, e, row, key)] the math lanes read in softmax_rows: key
    tiles below the tile's count, keys below P, rows below P (a row past
    P is computed and never written out)."""
    if bf16:
        ntiles = KMAXP // 8 if P > KMAXP - 16 else 2 * ((P + 15) >> 4)
    else:
        ntiles = KMAXP // 8 if P > KMAXP - 8 else ((P + 7) & ~7) >> 3
    out = []
    for lane in range(32):
        gr, t = lane >> 2, lane & 3
        for n in range(ntiles):
            for e in range(4):
                row = row0 + gr + (8 if e >= 2 else 0)
                key = 8 * n + 2 * t + (e & 1)
                if key < P and row < P:
                    out.append((n, lane, e, row, key))
    return out


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("G,H,P", [(32, 2, 128), (18, 4, 128), (2, 32, 128),
                                   (1024, 2, 128), (64, 16, 128),
                                   (6, 3, 37), (3, 1, 1), (5, 2, 113),
                                   (4, 2, 120), (7, 1, 121)])
def test_every_logit_written_and_read_once(G, H, P, bf16):
    warps, splits = _plan(G, H, P)
    assert 1 <= warps <= attention.OPTS_MAX_WARPS
    assert 16 * warps * splits >= P
    seen = {}
    for s in range(splits):
        for w in range(warps):
            row0 = 16 * (s * warps + w)
            if row0 >= P:           # the warp and its bias warp only arrive
                continue
            written = _tile_entries(P, row0, P > KMAXP - 8)
            for n, lane, e, row, key in _reads(P, row0, bf16):
                assert written[(n, lane, e)] == (row, key)
                seen[(row, key)] = seen.get((row, key), 0) + 1
    assert seen == {(r, c): 1 for r in range(P) for c in range(P)}


def _lookup(gc, table, b):
    """The kernel's bias of every (query, key) of each patch: byte offsets
    into each axis of a table staged with its axes AXIS_STRIDE floats
    apart, each the row offset 4 (gi + b) plus the key's -4 gj, clipped by
    max(min(., 8 b), 0) (__viaddmin_s32_relu), the three loads summed
    (tx + ty) + tz in fp32 -> (G, H, P, P)."""
    G, P, _ = gc.shape
    R, H = 2 * b + 1, table.shape[1]
    hi, base = 8 * b, 4 * b
    nk = -4 * gc.astype(np.int64)               # the staged coordinates
    a = base - nk                               # row offsets, (G, P, 3)
    off = np.maximum(np.minimum(a[:, :, None, :] + nk[:, None, :, :], hi),
                     0)                         # (G, P, P, 3)
    smem = np.zeros((TABLE_SMEM, H), np.float32)
    for i in range(3 * R):
        smem[i // R * AXIS_STRIDE + i % R] = table[i]
    row = off // 4 + AXIS_STRIDE * np.arange(3)
    t = smem[row]                               # (G, P, P, 3, H)
    out = (t[..., 0, :] + t[..., 1, :]) + t[..., 2, :]
    return out.transpose(0, 3, 1, 2)


@pytest.mark.parametrize("P,span", [(128, 4), (128, 200), (37, 60),
                                    (1, 3), (64, 1)])
def test_clipped_lookup_is_rpe_bias(P, span):
    rng = np.random.RandomState(P + span)
    G, H = 3, 5
    b = attention.pos_bound(P)
    gc = rng.randint(0, span, (G, P, 3)).astype(np.int32)
    table = (rng.randn(3 * (2 * b + 1), H) * 0.3).astype(np.float32)
    want = attention._rpe_logit_bias(
        (torch.from_numpy(gc), torch.from_numpy(table), b)).numpy()
    got = _lookup(gc, table, b)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("Dh", [8, 16, 24, 32])
def test_bias_kernel_fits_two_blocks_an_sm(Dh, bf16):
    if bf16:
        s = Dh if (Dh // 8) % 2 else Dh + 8      # attention_tile Layout16
        kv = 2 * KMAXP * s * 2
    else:
        kv = 2 * KMAXP * (Dh + 4) * 4            # attention_tile Layout
    warps = attention.OPTS_MAX_WARPS
    extra = KMAXP * 16 + warps * (KMAXP // 8) * 32 * 16
    static = KMAXP + TABLE_SMEM * 4              # the key mask, the table
    block = kv + extra + static + SMEM_RESERVED
    assert 3 * AXIS_STRIDE <= TABLE_SMEM
    assert 2 * attention.pos_bound(KMAXP) + 1 <= AXIS_STRIDE
    assert 2 * block <= SMEM_PER_SM
