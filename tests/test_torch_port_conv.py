"""PyTorch port vs the JAX package: the conv's plain versions at the release
widths, and the host-side plans of the conv kernels K2 and K7.

subm_conv_plain (K2's oracle and CPU path), conv_input_grad (the exact dx
that feeds the mirrored K2) and conv_weight_grad_plain (K7's oracle) are
held against the JAX XLA conv (`sparse_conv.subm_conv_apply`) and its
`jax.vjp` at every CPE width of the release policy (64, 128, 256, 512,
768), with Cin != Cout, and at the stem's K = 125, Cin = 7, on a few dozen
points with duplicate voxels. Tolerance 1e-4 abs in fp32 (the bar of
test_recorded_fixture_parity.py). The plans (tap ranges, row ranges and
scratch of K7) and the work shares chip_smoke.py prints are held against
independent numpy counts. The kernels against these plain versions on the
card: test_torch_port_gpu.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from robot3dlotus_tpu.ops.sparse_conv import (build_neighbor_map,
                                              subm_conv_apply)
from robot3dlotus_tpu_torch.ops import conv

ATOL = 1e-4


def T(a):
    return torch.from_numpy(np.array(a))


def _case(seed, ks, cin, cout, B=2, N=40, span=4):
    """A few dozen points on a span^3 grid (duplicates included), the JAX
    neighbour map, and seeded x, W, bias, output cotangent."""
    rng = np.random.RandomState(seed)
    gc = rng.randint(0, span, (B, N, 3)).astype(np.int32)
    mask = np.arange(N)[None] < np.array([[N], [N - 7]])[:B]
    nm = build_neighbor_map(jnp.asarray(gc), jnp.asarray(mask), ks, 4,
                            extent=16)
    x = (rng.randn(B, N, cin) * mask[..., None]).astype(np.float32)
    w = (rng.randn(ks ** 3, cin, cout) / np.sqrt(cin)).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    g = rng.randn(B, N, cout).astype(np.float32)
    return nm, x, w, bias, g


@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 128), (256, 256),
                                      (512, 512), (768, 768), (128, 256),
                                      (256, 128)])
def test_conv_plain_forward_dx_dw_match_jax(cin, cout):
    nm, x, w, bias, g = _case(cin + cout, 3, cin, cout)
    out, vjp = jax.vjp(lambda a, b, c: subm_conv_apply(a, nm, b, c),
                       jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    dx, dw, db = vjp(jnp.asarray(g))
    idx, ok = T(nm.idx), T(nm.ok)
    np.testing.assert_allclose(
        conv.subm_conv_plain(T(x), idx, ok, T(w), T(bias)).numpy(),
        np.asarray(out), atol=ATOL, rtol=0)
    np.testing.assert_allclose(conv.conv_input_grad(T(g), idx, ok,
                                                    T(w)).numpy(),
                               np.asarray(dx), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        conv.conv_weight_grad_plain(T(x), idx, ok, T(g)).numpy(),
        np.asarray(dw), atol=ATOL, rtol=0)
    # the autograd path of the CPU wrapper takes the same functions
    xt, wt, bt = (T(a).requires_grad_() for a in (x, w, bias))
    conv.subm_conv(xt, idx, ok, wt, bt).backward(T(g))
    for got, want in ((xt.grad, dx), (wt.grad, dw), (bt.grad, db)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


def test_stem_weight_grad_plain_matches_jax():
    """K7's stem shape: K = 125, Cin = 7, Cout = 64."""
    nm, x, w, _, g = _case(5, 5, 7, 64, N=48, span=5)
    _, vjp = jax.vjp(lambda b: subm_conv_apply(jnp.asarray(x), nm, b),
                     jnp.asarray(w))
    np.testing.assert_allclose(
        conv.conv_weight_grad_plain(T(x), T(nm.idx), T(nm.ok),
                                    T(g)).numpy(),
        np.asarray(vjp(jnp.asarray(g))[0]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("K", [1, 5, 27])
def test_conv_tap_ranges_partition_the_taps_in_order(K):
    """Every split count conv_tap_splits can return cuts the taps, as
    csrc/conv.cu does (range s: [s K / splits, (s + 1) K / splits)), into
    non-empty ranges that cover each tap once, in ascending order."""
    for splits in range(1, K + 1):
        ranges = [(s * K // splits, (s + 1) * K // splits)
                  for s in range(splits)]
        taps = [k for b, e in ranges for k in range(b, e)]
        assert taps == list(range(K))
        assert all(e > b for b, e in ranges)


@pytest.mark.parametrize("B,N,cout,want", [
    (32, 4096, 64, 1), (32, 256, 768, 1), (1, 4096, 64, 27),
    (1, 256, 768, 27), (1, 512, 512, 27), (2, 300, 128, 27),
    (4, 4096, 64, 1)])
def test_conv_tap_splits_fill_the_card(B, N, cout, want):
    """One range where the (row tile, channel tile, cloud) blocks give
    half the SMs one, else one tap a range (K ranges), the only other count
    that keeps a row's order of sums."""
    splits = conv.conv_tap_splits(B, N, 27, cout)
    assert splits == want
    blocks = -(-N // conv.CONV_ROWS) * -(-cout // conv.CONV_COLS) * B
    assert splits in (1, 27)
    assert (splits == 1) == (4 * blocks >= conv.CONV_TARGET_BLOCKS)


@pytest.mark.parametrize("B,N,K,cin,cout", [
    (32, 4096, 27, 64, 64), (32, 2304, 27, 128, 128), (32, 256, 27, 768, 768),
    (1, 4096, 27, 64, 64), (2, 300, 27, 128, 256), (32, 4096, 125, 7, 64),
    (1, 5, 27, 64, 64)])
def test_weight_grad_plan_covers_each_row_once(B, N, K, cin, cout):
    splits, per, nbytes = conv.weight_grad_plan(B, N, K, cin, cout)
    R = B * N
    ranges = [(s * per, min((s + 1) * per, R)) for s in range(splits)]
    rows = np.concatenate([np.arange(b, e) for b, e in ranges])
    np.testing.assert_array_equal(rows, np.arange(R))
    assert all(e > b for b, e in ranges)
    compacted = cin % 4 == 0 and cout % 4 == 0
    tiles = (K * -(-cin // 64) if compacted else -(-K * cin // 64)) * \
        -(-cout // 64)
    assert splits == 1 or per >= conv.WGRAD_MIN_ROWS or \
        tiles * splits >= conv.WGRAD_TARGET_BLOCKS
    lists = 4 * (2 * K * R + K * splits) if compacted else 0
    lists = (lists + 15) // 16 * 16
    part = 4 * splits * K * cin * cout if splits > 1 else 0
    assert nbytes == lists + part


@pytest.mark.parametrize("B,N,K,cin,cout", [
    (32, 4096, 27, 64, 64), (32, 2304, 27, 128, 128), (32, 256, 27, 768, 768),
    (32, 4096, 125, 7, 64), (1, 5, 27, 64, 64)])
def test_weight_grad_plan_bf16_takes_more_ranges(B, N, K, cin, cout):
    """At bf16 (unit 8) the row ranges cover each row once and aim at
    WGRAD_BF16_TARGET_BLOCKS: as many ranges as the fp32 plan or more, and
    the last range not empty."""
    splits, per, nbytes = conv.weight_grad_plan(B, N, K, cin, cout, unit=8)
    R = B * N
    assert (splits - 1) * per < R <= splits * per
    tiles = (K * -(-cin // 64) if cin % 8 == 0 else -(-K * cin // 64)) * \
        -(-cout // 64)
    assert splits == 1 or per >= conv.WGRAD_MIN_ROWS or \
        tiles * splits >= conv.WGRAD_BF16_TARGET_BLOCKS
    if cin % 8 == 0:
        assert splits >= conv.weight_grad_plan(B, N, K, cin, cout)[0]
    part = 4 * splits * K * cin * cout if splits > 1 else 0
    assert nbytes >= part


def _shares_np(ok, tile_rows=128, group=16, skip_rows=64):
    B, N, K = ok.shape
    kept = comp = tiles = 0
    for b in range(B):
        for k in range(K):
            for t0 in range(0, N, skip_rows):
                kept += ok[b, t0:t0 + skip_rows, k].any()
                tiles += 1
            for t0 in range(0, N, tile_rows):
                c = ok[b, t0:t0 + tile_rows, k].sum()
                comp += -(-c // group) * group
    return {"live": ok.sum() / ok.size, "tile_kept": kept / tiles,
            "compacted": comp / ok.size}


@pytest.mark.parametrize("N", [256, 300])
def test_link_shares_match_numpy(N):
    rng = np.random.RandomState(N)
    ok = rng.rand(2, N, 27) < 0.2
    ok[:, 64:128, 3] = False          # a tap dead in one 64-row tile
    got = chip_smoke.link_shares(T(ok))
    want = _shares_np(ok)
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-12)
    assert got["live"] <= got["compacted"] <= 1.0


def test_aligned_copies_only_misaligned_views():
    """The kernels read 16 bytes at a time: a view 4 bytes off is copied,
    an aligned tensor passes through."""
    t = torch.arange(40, dtype=torch.float32)
    assert t.data_ptr() % 16 == 0 and conv._aligned(t) is t
    v = t[1:]
    a = conv._aligned(v)
    assert a.data_ptr() % 16 == 0 and torch.equal(a, v)
