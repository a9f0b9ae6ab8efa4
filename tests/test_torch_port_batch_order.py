"""A row's order of sums in K2 (csrc/conv.cu) and K3 (csrc/stem.cu) does
not depend on the batch size, so that predict_batch of a cloud equals its
predict bit for bit (tests/test_eval_batching.py holds the JAX package to
that). The kernels cannot run here: their plans are enumerated as the
wrappers pick them (ops/conv.py conv_tap_splits, ops/stem.py
stem_conv_plan and stem_tap_ranges) at the release shapes for B in
{1, 2, 4, 32}, and their order of fp32 sums is emulated in PyTorch on a
seeded input at bf16:

  * K3 sums each 16-tap sum range (stem_sum_ranges, a function of K alone)
    into a fresh fp32 partial and adds the partials in order from 0, in
    the block that holds the whole row (splits 1) or in the sum kernel
    (one sum range a block);
  * K2 adds each live tap's fp32 sum to the row's total from 0 in
    ascending tap order, in the block's accumulator (splits 1) or in the
    reduce over one tap a range (splits K; a dead tap's partial is 0).

A cloud's rows alone (B = 1) and at slot 2 of a B = 4 batch, whose 16-row
groups straddle clouds (N not a multiple of 16), come out equal bit for
bit at every plan the wrappers pick, and within the bf16 bar of the plain
versions.
"""
import numpy as np
import pytest
import torch

from robot3dlotus_tpu_torch.ops import conv, stem
from robot3dlotus_tpu_torch.ops.bf16 import bf16_excess

BF16 = torch.bfloat16
BATCHES = (1, 2, 4, 32)
# the release policy's CPE convs at B = 1 (points a cloud, channels):
# encoder stages 0-4, decoder stages 3-0 (simple_policy_ptv3.yaml)
RELEASE_CPE = [(4096, 64), (2304, 128), (1024, 256), (512, 512),
               (256, 768), (512, 512), (1024, 256), (2304, 128), (4096, 128)]


@pytest.mark.parametrize("B", BATCHES)
def test_k3_plans_keep_the_sum_ranges(B):
    """The policy stem (125 taps, 7 -> 64) and an 8-channel stem, both
    dtypes: every plan stem_conv_plan picks cuts the taps into the sum
    ranges of stem_sum_ranges, one block range for all of them or one a
    block, so that every row's partials are the same ranges added in the
    same order."""
    sums = stem.stem_sum_ranges(125)
    assert sums == [(k, min(125, k + 16)) for k in range(0, 125, 16)]
    for cin, bf16 in ((7, False), (7, True), (8, False), (8, True)):
        cols, warps, splits, blocks = stem.stem_conv_plan(
            B, 4096, 125, cin, 64, bf16)
        ranges = stem.stem_tap_ranges(125, splits)
        assert ranges in ([(0, 125)], sums), (B, cin, bf16, splits)
        assert stem.stem_smem_bytes(125, cin, cols, splits, bf16,
                                    warps) <= stem.STEM_MAX_SMEM
        assert (splits == 1) == (B == 32)


@pytest.mark.parametrize("B", BATCHES)
def test_k2_plans_keep_the_tap_order(B):
    """Every CPE conv of the release policy and the Concat stem (125 taps,
    264 channels after padding): conv_tap_splits gives 1 range or one tap
    a range, so that a row adds its taps' fp32 sums in ascending order from
    0 at every B."""
    shapes = [(N, 27, c, c) for N, c in RELEASE_CPE] + [(4096, 125, 264, 64)]
    for N, K, cin, cout in shapes:
        splits = conv.conv_tap_splits(B, N, K, cout)
        ranges = [(s * K // splits, (s + 1) * K // splits)
                  for s in range(splits)]
        assert ranges in ([(0, K)], [(k, k + 1) for k in range(K)])
    assert conv.conv_tap_splits(32, 4096, 27, 64) == 1
    assert conv.conv_tap_splits(1, 256, 27, 768) == 27


def _map(rng, B, N, K, live=0.2):
    idx = torch.from_numpy(rng.randint(0, N, (B, N, K)).astype(np.int32))
    ok = torch.from_numpy(rng.rand(B, N, K) < live)
    ok[:, :, K // 2] = True                      # the centre tap
    return idx, ok


def _emulate_k3(x, idx, ok, w, splits):
    """K3 at bf16 as stem_conv16_kernel sums a plan of `splits` block
    ranges: in each block range, each 16-row group (rows flat over the
    clouds) runs every sum range's tap pairs into a fresh fp32 partial
    (a pair multiplied when any of the group's links is live: exact bf16
    products, the pair's 16 summed in fp64 and rounded, standing for the
    tensor core's sum) added to the block's total from 0; with several
    block ranges the sum kernel adds the blocks' totals from 0 in order.
    Rounded to bf16 once."""
    B, N, cin = x.shape
    K, _, cout = w.shape
    R = B * N
    G = -(-R // 16)
    xp = torch.zeros(R + 1, 8)
    xp[:R, :cin] = x.float().reshape(R, cin)
    wp = torch.zeros(K + 1, 8, cout)
    wp[:K, :cin] = w.float()
    src = (torch.arange(R) // N * N)[:, None] + idx.reshape(R, K).long()
    src = torch.where(ok.reshape(R, K), src, R)
    src = torch.cat([src, torch.full((16 * G - R, K), R)])
    src = torch.cat([src, torch.full((16 * G, 1), R)], 1)
    totals = []
    for kb, ke in stem.stem_tap_ranges(K, splits):
        total = torch.zeros(G, 16, cout)
        for rb, re in stem.stem_sum_ranges(K):
            if not kb <= rb < ke:
                continue
            acc = torch.zeros(G, 16, cout)
            for t0 in range(rb, re, 2):
                t1 = t0 + 1 if t0 + 1 < re else K
                s = src[:, [t0, t1]].reshape(G, 16, 2)
                live = (s < R).reshape(G, 32).any(1)
                a = xp[s].reshape(G, 16, 16)
                prod = (a.double() @ torch.cat([wp[t0], wp[t1]]).double())
                acc = torch.where(live[:, None, None], acc + prod.float(),
                                  acc)
            total = total + acc
        totals.append(total)
    out = totals[0]
    if splits > 1:
        out = torch.zeros(G, 16, cout)
        for t in totals:
            out = out + t
    return out.reshape(16 * G, cout)[:R].reshape(B, N, cout).to(BF16)


def _emulate_k2(x, idx, ok, w, bias, splits):
    """K2 at bf16 as subm_conv16_kernel sums a plan of 1 or K tap ranges:
    each live tap's sum over 64-channel stages (each stage's products
    summed in fp64 and rounded, standing for the tensor core's chain,
    added from 0) is added to the row's total from 0 in ascending tap
    order (splits 1), or written as its range's partial, 0 where the tap
    is dead, which the reduce adds from 0 in order (splits K); then the
    fp32 bias, rounded to bf16 once."""
    B, N, cin = x.shape
    K, _, cout = w.shape
    xf, wf = x.float(), w.float()
    total = torch.zeros(B, N, cout)
    parts = []
    for k in range(K):
        xs = torch.gather(xf, 1, idx[..., k].long()[..., None].expand(
            -1, -1, cin))
        t = torch.zeros(B, N, cout)
        for c0 in range(0, cin, 64):
            t = t + (xs[..., c0:c0 + 64].double() @
                     wf[k, c0:c0 + 64].double()).float()
        live = ok[..., k, None]
        total = torch.where(live, total + t, total)
        parts.append(torch.where(live, torch.zeros(()) + t,
                                 torch.zeros(())))
    if splits > 1:
        total = torch.zeros(B, N, cout)
        for p in parts:
            total = total + p
    return (total + bias).to(BF16)


def test_k3_rows_at_b1_equal_rows_in_b4():
    """The policy stem at bf16 (7 -> 64, 125 taps, 1000 points a cloud):
    cloud 2's rows at B = 1 (its plan: the 8 sum ranges a block), inside
    a B = 4 batch at its plan, and inside it with the whole row in one
    block (the B = 32 plan's form), bit-equal; within the bf16 bar of
    stem_conv_plain."""
    rng = np.random.RandomState(21)
    B, N, K = 4, 1000, 125
    idx, ok = _map(rng, B, N, K, live=0.17)
    x = torch.from_numpy(rng.randn(B, N, 7).astype(np.float32)).to(BF16)
    w = torch.from_numpy((rng.randn(K, 7, 64) * 0.1).astype(np.float32)) \
        .to(BF16)
    one = slice(2, 3)
    s1 = stem.stem_conv_plan(1, N, K, 7, 64, True)[2]
    s4 = stem.stem_conv_plan(B, N, K, 7, 64, True)[2]
    alone = _emulate_k3(x[one], idx[one], ok[one], w, s1)
    batch = _emulate_k3(x, idx, ok, w, s4)
    whole = _emulate_k3(x, idx, ok, w, 1)
    assert s1 == s4 == 8
    assert torch.equal(alone[0], batch[2]) and torch.equal(batch, whole)
    assert bf16_excess(batch, stem.stem_conv_plain(x, idx, ok, w)) <= 0.0


def test_k2_rows_at_b1_equal_rows_in_b4():
    """A CPE conv at bf16 (27 taps, 64 -> 64 with an fp32 bias, 300 points
    a cloud): cloud 2's rows at B = 1 (one tap a range) equal its rows in a
    B = 4 batch at its plan and with one range, bit for bit; within the
    bf16 bar of subm_conv_plain."""
    rng = np.random.RandomState(7)
    B, N, K, C = 4, 300, 27, 64
    idx, ok = _map(rng, B, N, K)
    x = torch.from_numpy(rng.randn(B, N, C).astype(np.float32)).to(BF16)
    w = torch.from_numpy((rng.randn(K, C, C) * 0.05).astype(np.float32)) \
        .to(BF16)
    bias = torch.from_numpy(rng.randn(C).astype(np.float32) * 0.1)
    one = slice(2, 3)
    s1 = conv.conv_tap_splits(1, N, K, C)
    s4 = conv.conv_tap_splits(B, N, K, C)
    alone = _emulate_k2(x[one], idx[one], ok[one], w, bias, s1)
    batch = _emulate_k2(x, idx, ok, w, bias, s4)
    whole = _emulate_k2(x, idx, ok, w, bias, 1)
    assert s1 == K
    assert torch.equal(alone[0], batch[2]) and torch.equal(batch, whole)
    assert bf16_excess(batch, conv.subm_conv_plain(x, idx, ok, w, bias)) \
        <= 0.0
