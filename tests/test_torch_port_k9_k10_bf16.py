"""K9 and K10 at bf16 (the motion planner's categorical stem and the
stems' input gradients under compute_dtype bfloat16), on the CPU.

- The bf16 wrappers on CPU tensors (their plain versions) against the JAX
  `gather_rows_smallc` at bf16 (Pallas in interpret mode) and its VJP
  (`_smallc_bwd_call`): K9 bit-equal, K10 within the one-rounding bar of
  ops/bf16.py, at C in {1, 4, 5, 7, 8, 9, 20, 32}, int32 and int64
  indices, negative and sentinel rows, M * C not a multiple of 8.
- K9's bf16 kernel (csrc/gather_smallc.cu gather_smallc16_kernel)
  emulated in numpy from its plan (ops/gather.py smallc16_plan,
  smallc16_row_words): the 8-byte words that cover a row, the funnel
  shift by the row's offset, the byte permutes that pack 4 rows into
  whole 8-byte words and the staged tile, at every C from 1 to 32, bit
  for bit against the plain gather; every row gathered once, no word read
  outside the row's own.
- K10's bf16 kernel (scatter_smallc16_kernel) emulated from its plan
  (scatter_smallc16_chunks, the bf16 scatter_smallc_plan): each warp
  chunk's live rows listed in the order of its ballots, every live row's
  C values added once into its slab row, the ranges' partials summed in
  order and rounded once.
The kernels themselves run on the card: test_torch_port_gpu.py.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robot3dlotus_tpu.ops import pallas_gather as jgather
from robot3dlotus_tpu_torch.ops import gather
from test_torch_port_bf16_train import f32, jbf, jrun, tbf, within_bar


def T(a):
    return torch.from_numpy(np.array(a))


def _indices(rng, B, M, N, dtype):
    """Indices in [0, N), a fifth of them sentinels (N, N + 5, -1)."""
    idx = rng.randint(0, N, (B, M)).astype(dtype)
    dead = rng.rand(B, M) < 0.2
    idx[dead] = rng.choice([N, N + 5, -1], dead.sum())
    return idx


@pytest.mark.parametrize("C,dtype", [(1, np.int32), (4, np.int64),
                                     (5, np.int32), (7, np.int64),
                                     (8, np.int32), (9, np.int64),
                                     (20, np.int32), (32, np.int64)])
def test_k9_k10_bf16_wrappers_match_jax(C, dtype):
    """gather_rows_smallc at bf16 bit-equal to the JAX gather, and its
    backward (K10's bf16 plain version: fp32 sums, one rounding) within
    the bar of the JAX VJP, the direct call equal to the autograd one
    (N a multiple of 128 and M of 8: the JAX package's Pallas path; its
    XLA fallback scatter-adds in bf16)."""
    rng = np.random.RandomState(C)
    B, N, M = 2, 128, 1024
    idx = _indices(rng, B, M, N, dtype)
    idx[1, 200:500] = 3                         # one hot destination
    x = rng.randn(B, N, C).astype(np.float32)
    g = rng.randn(B, M, C).astype(np.float32)
    xt = tbf(x).requires_grad_()
    got = gather.gather_rows_smallc(xt, T(idx))
    assert got.dtype == torch.bfloat16
    want, vjp = jrun(lambda a, gg: (lambda o, f: (o, f(gg)[0]))(
        *jax.vjp(lambda t: jgather.gather_rows_smallc(
            t, jnp.asarray(idx.astype(np.int32)), interpret=True), a)),
        jbf(x), jbf(g))
    np.testing.assert_array_equal(f32(got), f32(want))
    got.backward(tbf(g))
    within_bar(xt.grad, vjp, what=f"K10 bf16 C = {C}")
    direct = gather.scatter_rows_smallc_add(tbf(g), T(idx), N)
    assert torch.equal(direct.view(torch.int16), xt.grad.view(torch.int16))


# ------------------------------------------------ K9's bf16 kernel -----

def _funnel_r(lo, hi, s):
    return ((hi << 32 | lo) >> s) & 0xFFFFFFFF


def _byte_perm(a, b, sel):
    src = [(a >> 8 * k) & 0xFF for k in range(4)] + \
        [(b >> 8 * k) & 0xFF for k in range(4)]
    return sum(src[(sel >> 4 * n) & 7] << 8 * n for n in range(4))


def _k9_bf16_emulated(x16, idx, touched):
    """gather_smallc16_kernel in numpy on x16 (B, N, C) uint16: returns
    out (B, M, C) uint16; adds to `touched` each 8-byte word of x (from
    its aligned base, all clouds in one buffer) that a load read."""
    B, N, C = x16.shape
    M = idx.shape[1]
    W, P = gather.smallc16_row_words(C)
    tile, threads, blocks = gather.smallc16_plan(M, C)
    assert threads * 4 == tile
    raw = np.zeros(len(touched) * 4, np.uint16)
    raw[:B * N * C] = x16.reshape(-1)
    words32 = raw.view(np.uint32)               # little endian, as the card
    out = np.full((B, M * C), 0xDEAD, np.uint16)
    for b in range(B):
        for blk in range(blocks):
            r0 = blk * tile
            rows = min(tile, M - r0)
            staged = np.zeros(threads * 2 * C, np.uint32)
            for t in range(threads):
                rr = []
                for k in range(4):
                    m = r0 + 4 * t + k
                    i = int(idx[b, m]) if 4 * t + k < rows else -1
                    live = 0 <= i < N
                    byte = 2 * (b * N + i) * C if live else 0
                    o, base = byte & 7, byte & ~7
                    last = (o + 2 * C - 1) >> 3
                    u = [0] * (2 * W + 1)
                    for w in range(W):
                        if live and w <= last:
                            q = (base >> 3) + w
                            touched[q] += 1
                            u[2 * w] = int(words32[2 * q])
                            u[2 * w + 1] = int(words32[2 * q + 1])
                    qq, s = bool(o & 4), (o & 2) * 8
                    rr.append([_funnel_r(u[j + 1] if qq else u[j],
                                         u[j + 2] if qq else u[j + 1], s)
                               for j in range(P)])
                for w in range(2 * C):
                    v0, v1 = 2 * w, 2 * w + 1
                    c0, c1 = v0 % C, v1 % C
                    sel = (0x32 if c0 & 1 else 0x10) | \
                        (0x7600 if c1 & 1 else 0x5400)
                    staged[t * 2 * C + w] = _byte_perm(
                        rr[v0 // C][c0 // 2], rr[v1 // C][c1 // 2], sel)
            out[b, r0 * C:(r0 + rows) * C] = staged.view(np.uint16)[
                :rows * C]
    return out.reshape(B, M, C)


@pytest.mark.parametrize("C", list(range(1, 33)))
def test_k9_bf16_kernel_emulated(C):
    """The kernel's words, shifts and permutes give the plain gather bit
    for bit at every C, with clouds of N C not a multiple of 4 (the second
    cloud's rows then start off the first's 8-byte grid); each live row
    reads only the words that hold its own bytes (none past x's last
    word), a sentinel row none."""
    rng = np.random.RandomState(100 + C)
    B, N, M = 2, 29, 90 if C != 5 else 1100     # C = 5: two tiles
    idx = _indices(rng, B, M, N, np.int64)
    x = tbf(rng.randn(B, N, C).astype(np.float32))
    x16 = x.view(torch.int16).numpy().view(np.uint16)
    touched = np.zeros(-(-B * N * C // 4), np.int64)
    got = _k9_bf16_emulated(x16, idx, touched)
    want = gather.gather_rows_plain(x, T(idx)).view(torch.int16).numpy()
    np.testing.assert_array_equal(got.view(np.int16), want)
    W, _ = gather.smallc16_row_words(C)
    expect = np.zeros_like(touched)
    for b, m in zip(*np.nonzero((idx >= 0) & (idx < N))):
        first = 2 * (b * N + idx[b, m]) * C
        last = first + 2 * C - 1
        expect[first // 8:last // 8 + 1] += 1
        assert last // 8 - first // 8 < W
    np.testing.assert_array_equal(touched, expect)


@pytest.mark.parametrize("M,C", [(1, 5), (512000, 5), (4096, 4),
                                 (1023, 17), (70000, 32)])
def test_k9_bf16_plan_covers_rows(M, C):
    """Every row of a cloud is one thread's k-th of 4 in one tile; tiles of
    1024 rows up to C = 16 and 512 above, the staged bytes 32 KB at
    most; the planner stem's B = 1 call (512,000 rows) spreads over 500
    blocks, more than 3 an SM of the H100's 132."""
    tile, threads, blocks = gather.smallc16_plan(M, C)
    rows = np.arange(blocks)[:, None, None] * tile + \
        4 * np.arange(threads)[None, :, None] + np.arange(4)[None, None]
    rows = rows[rows < M]
    np.testing.assert_array_equal(np.sort(rows), np.arange(M))
    assert threads * 4 * 2 * C <= 32 * 1024
    if M == 512000:
        assert blocks == 500 and blocks > 3 * gather.SMALLC_SMS


# ----------------------------------------------- K10's bf16 kernel -----

def _k10_bf16_emulated(g, idx, n, ranges, window):
    """scatter_smallc16_kernel (and the ranges' in-order sum) in numpy:
    every block (range, cloud, slab) walks its warps' chunks, lists each
    chunk's live rows as the kernel's ballots order them (a lane's row k
    of 4, then lane) and adds each listed row's C values into its fp32
    slab copy;
    returns dx rounded once to bf16 and, by (cloud, row), how many times
    a row was listed."""
    B, M, C = g.shape
    gf = g.float().numpy()
    slabs = -(-n // window)
    parts = np.zeros((ranges, B, n, C), np.float32)
    listed = np.zeros((B, M), np.int64)
    for r, (m0, m1) in enumerate(gather.scatter_smallc_ranges(M, ranges)):
        for b in range(B):
            for s in range(slabs):
                d0 = s * window
                rows_w = min(window, n - d0)
                copy = np.zeros((rows_w, C), np.float32)
                per_lane = gather.SMALLC16_CHUNK // 32
                for chunks in gather.scatter_smallc16_chunks(m0, m1):
                    for c0, c1 in chunks:
                        items = []
                        for k in range(per_lane):
                            for lane in range(32):
                                m = c0 + per_lane * lane + k
                                if m < c1 and 0 <= idx[b, m] - d0 < rows_w:
                                    items.append(m)
                        assert len(items) <= gather.SMALLC16_CHUNK
                        for m in items:
                            copy[idx[b, m] - d0] += gf[b, m]
                            listed[b, m] += 1
                parts[r, b, d0:d0 + rows_w] = copy
    total = parts[0].copy()
    for r in range(1, ranges):
        total += parts[r]
    return torch.from_numpy(total).to(torch.bfloat16), listed


@pytest.mark.parametrize("B,M,n,C,plan", [
    (2, 3000, 300, 7, None),            # the wrapper's plan
    (1, 5000, 1000, 5, (3, 1000)),      # ranges > 1
    (2, 2100, 700, 8, (2, 256)),        # ranges and slabs > 1
    (1, 700, 50, 1, (1, 17)),           # slabs > 1, a partial chunk
])
def test_k10_bf16_kernel_emulated(B, M, n, C, plan):
    """Every live row is listed and added once (once per slab that holds
    its destination), a dead one never; the partials summed in order and
    rounded once are within the bar of the plain version."""
    rng = np.random.RandomState(M + C)
    idx = _indices(rng, B, M, n, np.int32)
    g = tbf(rng.randn(B, M, C).astype(np.float32))
    ranges, window = plan or gather.scatter_smallc_plan(B, M, n, C, True)
    assert gather.scatter_smallc_smem(C, window, True) <= gather.SMALLC_SMEM
    got, listed = _k10_bf16_emulated(g, idx, n, ranges, window)
    live = (idx >= 0) & (idx < n)
    np.testing.assert_array_equal(listed, live.astype(np.int64))
    within_bar(got, gather.scatter_rows_smallc_add_plain(g, T(idx), n),
               what=f"K10 bf16 emulated {plan}")


def test_k10_bf16_plans():
    """At bf16 up to C = 8 one 32-warp block an SM holds a cloud's whole
    slab beside the warps' chunks and lists (n = 4096: one slab), so the
    policy and planner stems' B = 32 calls take 4 ranges a cloud (128
    blocks) and the B = 1 stem 62; C > 8 keeps the fp32 plan."""
    assert gather.scatter_smallc_plan(32, 512000, 4096, 7, True) == (4, 4096)
    assert gather.scatter_smallc_plan(32, 512000, 4096, 5, True) == (4, 4096)
    assert gather.scatter_smallc_plan(1, 512000, 4096, 5, True) == (62, 4096)
    assert gather.scatter_smallc_plan(32, 512000, 4096, 8, True) == (4, 4096)
    assert gather.scatter_smallc_smem(8, 4096, True) == 131072 + 32 * 2560
    assert gather.scatter_smallc_smem(7, 4096, True) == 114688 + 32 * 2304
    assert gather.scatter_smallc_blocks_per_sm(7, 4096, True) == 1
    for C in (9, 20, 32):
        assert gather.scatter_smallc_plan(32, 512000, 4096, C, True) == \
            gather.scatter_smallc_plan(32, 512000, 4096, C)
    chunks = gather.scatter_smallc16_chunks(1024, 9000)
    assert len(chunks) == gather.SMALLC16_WARPS == 32
    rows = sorted(r for w in chunks for c0, c1 in w for r in range(c0, c1))
    assert rows == list(range(1024, 9000))
