"""The orders of the redesigned K8 (csrc/gather.cu scatter_rows_sum_kernel)
and K3 at bf16 (csrc/stem.cu stem_conv16_kernel), emulated on the CPU
where no card can run them, held against the plain versions and the JAX
package:

  * K8 adds each destination row's sources in increasing source row order,
    from 0, in fp32 (gather.scatter_rows_add_ordered): on indices with
    sentinels (negative, N, past N), duplicates and no order, that sum
    rounded to bf16 is within the bar of ops/bf16.py of jax.vjp of the JAX
    permute_rows at bf16 (pallas_gather.py `_permute_op_bwd`, the Pallas
    kernel in interpret mode: fp32 sums, one rounding; the XLA path's
    scatter-add rounds at every add and is not the rule), the sentinels
    sent to the zero row the JAX decoder appends; its fp32 sums are within
    1e-6 of the plain version's. K8's correctness relies on no property of the
    indices; its speed on few sources a row. The step's maps have the
    structure chip_smoke.py and the PERF.md step-0 run measured, asserted
    here on the JAX package's own maps for seeded clouds: an unpool's
    clusters are runs (nondecreasing, the dropped tail at child_cap), a
    conv's owner (the centre tap's index) is at most its row and owns
    itself;
  * K3 at bf16 walks each 16-row group's tap range in pairs of taps, k = 16
    (two taps x 8 channels, x and W zero-padded from 7 channels, a range's
    odd last tap paired with a zero tap), skips a pair none of the group's
    32 links reaches, multiplies each live pair once (bf16 products exact,
    fp32 sums), adds the 16-tap sum ranges' fp32 partials in order from 0
    (stem_sum_ranges, the same at every plan) and rounds once: every live link multiplied exactly once, and the result within
    the bf16 bar of stem_conv_plain and of the JAX stem at bf16 (the XLA
    subm_conv_apply), on the wrapper's plans at B = 1 (tap ranges) and
    B = 4, Cin 7 and 8, Cout 64 and 68 (zero weight columns to 72).

The kernels themselves run in tests/test_torch_port_gpu.py (`gpu`: K8
bit-equal to scatter_rows_add_ordered) and in chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robot3dlotus_tpu.ops import pallas_gather as jgather
from robot3dlotus_tpu.ops.pooling import build_pool_maps as jpool_maps
from robot3dlotus_tpu.ops.sparse_conv import (
    build_neighbor_map as jneighbor_map, subm_conv_apply)
from robot3dlotus_tpu_torch.ops import gather, stem
from robot3dlotus_tpu_torch.ops.bf16 import bf16_excess

BF16 = torch.bfloat16
NO_EXCESS = {"xla_allow_excess_precision": False}


def T(a):
    return torch.from_numpy(np.array(a))


def jbf(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def f32(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def jrun(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)(
        *args)


def within_bar(got, want, relative=False):
    w = torch.from_numpy(f32(want))
    assert bf16_excess(got, w, relative=relative) <= 0.0, \
        np.abs(f32(got) - w.numpy()).max()


# ------------------------------------------------------------------ K8 ----

def _k8_index(rng, kind, B, M, n):
    """Unsorted indices with sentinels (a fifth at n, a few negative or past
    n), with heavy duplicates (half the rows on 3 destinations), or runs
    (an unpool's clusters, with sentinels)."""
    idx = rng.randint(0, n, (B, M))
    if kind == "heavy":
        idx[:, ::2] = rng.randint(0, 3, (B, (M + 1) // 2))
    elif kind == "runs":
        idx = np.minimum(np.cumsum(rng.rand(B, M) < 0.3, 1), n - 1)
    idx[rng.rand(B, M) < 0.2] = n
    idx[:, :3] = [-1, n + 9, -5]
    return idx.astype(np.int32)


@pytest.mark.parametrize("kind", ["unsorted", "heavy", "runs"])
@pytest.mark.parametrize("D", [8, 64])
def test_k8_order_matches_jax_vjp_bf16(D, kind):
    rng = np.random.RandomState(D + len(kind))
    B, M, n = 2, 160, 48
    idx = _k8_index(rng, kind, B, M, n)
    g = rng.randn(B, M, D).astype(np.float32)
    gt = T(g).to(BF16)
    order = gather.scatter_rows_add_ordered(gt, T(idx), n)
    np.testing.assert_allclose(
        order.numpy(), gather.scatter_rows_add_plain(gt, T(idx), n).numpy(),
        rtol=0, atol=1e-6)
    # the JAX decoder's form: a zero row at n, every sentinel sent to it
    jidx = jnp.asarray(np.where((idx >= 0) & (idx < n), idx, n))
    x = np.zeros((B, n + 1, D), np.float32)
    want = jrun(lambda a, gg: jax.vjp(lambda t: jgather.permute_rows(
        t, jidx, impl="pallas_interpret"), a)[1](gg)[0], jbf(x), jbf(g))
    within_bar(order.to(BF16), want[:, :n], relative=True)


def _sorted_codes(rng, B, N, counts):
    """(B, N) int32 ascending serialization codes of seeded clouds with
    repeated voxels (several points a voxel), the padding at the tail."""
    codes = np.sort(rng.randint(0, 1 << 12, (B, N)), axis=1)
    codes[np.arange(N)[None] >= counts[:, None]] = (1 << 30)
    return codes.astype(np.int32)


def test_k8_step_index_structure_on_jax_maps():
    """What chip_smoke.py measures on the step's maps, on the JAX package's
    own maps: the unpool's clusters (the sorted-resident frame) are runs,
    nondecreasing over the live rows with the dropped tail at child_cap;
    the conv owner index (the centre tap) is at most its row and owns
    itself, and rows that share a voxel point at its lowest row."""
    rng = np.random.RandomState(5)
    B, N, cap = 3, 512, 200
    counts = np.array([512, 400, 300])
    maps = jpool_maps(jnp.asarray(_sorted_codes(rng, B, N, counts)), None,
                      None, jnp.asarray(counts), cap)
    cluster = np.asarray(maps.cluster)
    for b in range(B):
        live = cluster[b][cluster[b] < cap]
        assert (np.diff(live) >= 0).all() and len(live) > 0
        assert (cluster[b][counts[b]:] == cap).all()
    gc = rng.randint(0, 6, (B, N, 3)).astype(np.int32)   # duplicate voxels
    mask = np.arange(N)[None] < counts[:, None]
    nm = jneighbor_map(jnp.asarray(gc), jnp.asarray(mask), 3, 3, extent=8)
    idx, ok = np.asarray(nm.idx), np.asarray(nm.ok)
    owner, valid = idx[..., 13], ok[..., 13]
    rows = np.arange(N)[None]
    assert (owner[valid] <= np.broadcast_to(rows, owner.shape)[valid]).all()
    assert (np.take_along_axis(owner, np.where(valid, owner, 0), 1)[valid]
            == owner[valid]).all()
    assert (owner[valid] != np.broadcast_to(rows, owner.shape)[valid]).any()


# ------------------------------------------------------------------ K3 ----

def _emulate_k3_bf16(x, idx, ok, w):
    """K3 at bf16 as stem_conv16_kernel walks it, at any plan that
    stem_conv_plan picks: for each sum range (stem_sum_ranges), each
    16-row group (rows flat over the clouds) runs the range's tap pairs;
    a pair is multiplied when any of the group's 32 links is live, as one
    (16 x 16) x (16 x Cout) product of bf16 values (x and W padded to 8
    channels, a missing second tap zero) added to the range's fp32
    partial; the partials added in order from 0, rounded to bf16 once.
    Returns the output and the (row, tap) links multiplied, counted per
    link."""
    B, N, cin = x.shape
    K, _, cout = w.shape
    R = B * N
    G = -(-R // 16)
    xp = torch.zeros(R + 1, 8)                       # row R: a dead link
    xp[:R, :cin] = x.float().reshape(R, cin)
    wp = torch.zeros(K + 1, 8, cout)                 # tap K: a zero tap
    wp[:K, :cin] = w.float()
    src = (torch.arange(R) // N * N)[:, None] + idx.reshape(R, K).long()
    src = torch.where(ok.reshape(R, K), src, R)
    src = torch.cat([src, torch.full((16 * G - R, K), R)])  # past the rows
    src = torch.cat([src, torch.full((16 * G, 1), R)], 1)   # tap K: dead
    total = torch.zeros(G, 16, cout)
    seen = torch.zeros(16 * G, K + 1, dtype=torch.long)
    for kb, ke in stem.stem_sum_ranges(K):
        acc = torch.zeros(G, 16, cout)
        for t0 in range(kb, ke, 2):
            t1 = t0 + 1 if t0 + 1 < ke else K
            s = src[:, [t0, t1]].reshape(G, 16, 2)
            live = (s < R).reshape(G, 32).any(1)
            a = xp[s].reshape(G, 16, 16)                    # [tap t0 | t1]
            bm = torch.cat([wp[t0], wp[t1]])                # (16, cout)
            prod = (a.double() @ bm.double()).float()       # exact products
            acc = torch.where(live[:, None, None],
                              (acc.double() + prod.double()).float(), acc)
            seen[:, [t0, t1]] += live.repeat_interleave(16)[:, None].long()
        total = total + acc
    out = total.reshape(16 * G, cout)[:R].reshape(B, N, cout)
    return out.to(BF16), seen[:R, :K].reshape(B, N, K)


def _stem_cloud(seed, B, N):
    rng = np.random.RandomState(seed)
    gc = np.stack([np.stack(np.unravel_index(
        rng.choice(12 ** 3, N, replace=False), (12,) * 3), -1)
        for _ in range(B)]).astype(np.int32)
    mask = np.ones((B, N), bool)
    mask[-1, N - 9:] = False
    return rng, gc, mask


@pytest.mark.parametrize("B,cin,cout", [(1, 7, 64), (4, 7, 64), (1, 8, 68),
                                        (4, 8, 64)])
def test_k3_bf16_pairs_emulated(B, cin, cout):
    """The wrapper's plan (tap ranges at B = 1); every live link
    multiplied exactly once; the emulated pairs within the bf16 bar of
    stem_conv_plain and of the JAX stem at bf16 (XLA)."""
    N = 256
    rng, gc, mask = _stem_cloud(B * cin + cout, B, N)
    nm = jneighbor_map(jnp.asarray(gc), jnp.asarray(mask), 5, 4, extent=16)
    x = rng.randn(B, N, cin).astype(np.float32)
    w = (rng.randn(125, cin, cout) * 0.1).astype(np.float32)
    xt, wt = T(x).to(BF16), T(w).to(BF16)
    idx, ok = T(nm.idx), T(nm.ok)
    cols, warps, splits, blocks = stem.stem_conv_plan(B, N, 125, cin, cout,
                                                      bf16=True)
    assert cols == 64 and stem.stem_smem_bytes(
        125, cin, cols, splits, True, warps) <= stem.STEM_MAX_SMEM
    assert splits > 1 if B == 1 else True
    got, seen = _emulate_k3_bf16(xt, idx, ok, wt)
    assert torch.equal(seen[ok], torch.ones(int(ok.sum()), dtype=torch.long))
    want = stem.stem_conv_plain(xt, idx, ok, wt)
    assert bf16_excess(got, want) <= 0.0
    jwant = jrun(lambda a, c: subm_conv_apply(a, nm, c), jbf(x), jbf(w))
    within_bar(got, jwant)
    within_bar(stem.stem_conv(xt, idx, ok, wt), jwant)


@pytest.mark.parametrize("splits", [1, 3, 5, 8])
def test_k3_bf16_tap_ranges_pair_up(splits):
    """Block ranges of 16-tap sum ranges (stem_tap_ranges): every range
    starts on an even tap, so its pairs are (kb, kb + 1), ...; only a range
    ending at K = 125 has an odd count, its last tap paired with a zero
    tap (stem_smem_bytes stages it); the shared memory at the B = 32 plan
    is under an H100 block's 227 KB with 64 columns and 16 warps."""
    ranges = stem.stem_tap_ranges(125, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == 125
    for (kb, ke), (nb, _) in zip(ranges, ranges[1:] + [(125, 0)]):
        assert kb % 2 == 0 and ke == nb
        assert (ke - kb) % 2 == 0 or ke == 125
    assert stem.stem_conv_plan(32, 4096, 125, 7, 64, bf16=True) == \
        (64, 16, 1, 132)
    assert stem.stem_conv_plan(1, 4096, 125, 8, 64, bf16=True) == \
        (64, 16, 8, 16)
    assert stem.stem_smem_bytes(125, 7, 64, 1, True, 16) == \
        126 * 8 * 64 * 2 + 16 * (512 + 16 * 18 * 4)
