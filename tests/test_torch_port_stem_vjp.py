"""PyTorch port vs the JAX package: the stem conv's input gradient, the
categorical stem's feature gradient, and K10's block plan.

- The port's `stem_conv` input gradient (the stencil product's VJP, one
  matmul, then K10's plain version on the flat map with dead links at the
  sentinel row) against `jax.vjp` with respect to the features of the JAX
  stem: its exact XLA conv, and the windowed Pallas gather in interpret
  mode (`stem_gather_windowed`, whose VJP is `_windowed_gather_bwd` ->
  `_smallc_bwd_call`, K10's TPU kernel, plus the far links' row gathers),
  on the 4096-point release cloud of test_torch_port_k1_k3.py, Cin 7,
  Cout 64; the weight gradient beside it.
- The motion planner's categorical stem (K9 then K10 in the port) with its
  feature input requiring a gradient, against the JAX subm_conv_apply on
  its XLA path and on its K9 path in interpret mode.
- K10's plan (ops/gather.py scatter_smallc_plan, scatter_smallc_ranges),
  enumerated in numpy as csrc/gather_smallc.cu walks it: the slabs cover
  every destination (row, channel) once, each range's tiles cover every
  g row once per slab, and the ranges' partials, added in order, give the
  scatter-add; the release plans fill the card.
- At bf16: K10's plain version against the Pallas VJP, the policy stem's
  input gradient against the windowed Pallas stem's and the categorical
  stem's feature gradient against the JAX one (bars stated below).
Bar: <= 1e-4 * max(1, |ref|) in fp32. The kernel itself runs on the card:
test_torch_port_gpu.py.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robot3dlotus_tpu.ops import pallas_gather as jgather
from robot3dlotus_tpu.ops import pallas_stem as jstem
from robot3dlotus_tpu.ops import sparse_conv as jsparse
from robot3dlotus_tpu_torch.ops import gather, sparse_conv, stem
from test_torch_port_bf16_train import (XLA_DX_BAR, f32, jbf, jrun, tbf,
                                        within, within_bar)
from test_torch_port_k1_k3 import _release_cloud

ATOL = 1e-4


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.fixture(scope="module")
def release_stem():
    """The release cloud's k=5 map, features (Cin 7), weight (Cout 64) and
    a seeded output cotangent; the port's dx and dW of stem_conv."""
    rng = np.random.RandomState(7)
    gc = _release_cloud(rng)[None].astype(np.int32)
    mask = np.ones((1, 4096), bool)
    nm = jsparse.build_neighbor_map(jnp.asarray(gc), jnp.asarray(mask), 5,
                                    7, extent=128)
    feat = rng.randn(1, 4096, 7).astype(np.float32)
    w = (rng.randn(125, 7, 64) * 0.1).astype(np.float32)
    gout = rng.randn(1, 4096, 64).astype(np.float32)
    ft, wt = T(feat).requires_grad_(), T(w).requires_grad_()
    idx, ok = T(np.asarray(nm.idx)), T(np.asarray(nm.ok))
    stem.stem_conv(ft, idx, ok, wt).backward(T(gout))
    # the same through autograd of the plain version
    fp = T(feat).requires_grad_()
    stem.stem_conv_plain(fp, idx, ok, T(w)).backward(T(gout))
    return nm, feat, w, gout, ft.grad, wt.grad, fp.grad


def test_stem_input_grad_matches_jax_xla(release_stem):
    nm, feat, w, gout, dx, dw, autograd_dx = release_stem
    _, vjp = jax.vjp(lambda f, ww: jsparse.subm_conv_apply(f, nm, ww),
                     jnp.asarray(feat), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(gout))
    _close(dx, jdx, "dx")
    _close(dw, jdw, "dW")
    _close(autograd_dx, jdx, "autograd of stem_conv_plain")
    assert np.abs(np.asarray(jdx)).max() > 0.1


def test_stem_input_grad_matches_jax_pallas_interpret(release_stem,
                                                      monkeypatch):
    """jax.vjp of the windowed stem (near links in the Pallas gather,
    interpret mode; links outside its window through its far lists, none
    dropped) followed by the stencil product: its feature gradient is
    _windowed_gather_bwd's one _smallc_bwd_call (interpret) plus the far
    rows' gather VJP."""
    nm, feat, w, gout, dx, _, _ = release_stem
    calls = []

    def counted(idx, g, n, interpret):
        calls.append((tuple(g.shape), n, interpret))
        return bwd(idx, g, n, interpret)

    bwd = jgather._smallc_bwd_call
    monkeypatch.setattr(jgather, "_smallc_bwd_call", counted)
    jw = jnp.asarray(w)

    def windowed(f):
        g, (rows, far_dst, far_ok, dropped) = jstem.stem_gather_windowed(
            f, nm, interpret=True, far_per_tap=4096)
        out = jnp.einsum("bnkc,kcd->bnd",
                         jnp.where(nm.ok[..., None], g, 0.0), jw)
        fc = jnp.einsum("bkfc,kcd->bkfd",
                        jnp.where(far_ok[..., None], rows, 0.0), jw)
        out = out.at[0, far_dst.reshape(-1)].add(fc.reshape(-1, 64))
        return out, (dropped, far_ok)

    _, vjp, (dropped, far_ok) = jax.vjp(windowed, jnp.asarray(feat),
                                        has_aux=True)
    assert int(dropped.sum()) == 0 and bool(far_ok.any())
    jdx, = vjp(jnp.asarray(gout))
    assert calls == [((1, 4096 * 128, 8), 4096, True)]
    _close(dx, jdx, "dx vs the windowed Pallas stem")


@pytest.mark.parametrize("interpret", [False, True])
def test_categorical_stem_feature_grad_matches_jax(monkeypatch, interpret):
    """The motion planner's stem (features + one-based label channel
    through K9, sentinel N at missing links) with its features requiring a
    gradient: dfeat (K10's plain version), dW and the label table's
    gradient against jax.vjp of the JAX subm_conv_apply on its XLA path
    or, with the test seam set, its K9 path in interpret mode."""
    monkeypatch.setattr(jsparse, "_SMALLC_INTERPRET", interpret)
    rng = np.random.RandomState(5)
    B, N, C, E = 2, 256, 4, 16
    gc = rng.randint(0, 9, (B, N, 3)).astype(np.int32)
    mask = np.arange(N)[None] < np.array([[N], [N - 40]])
    jn = jsparse.build_neighbor_map(jnp.asarray(gc), jnp.asarray(mask), 5, 4,
                                    extent=16)
    nm = sparse_conv.NeighborMap(T(jn.idx), T(jn.ok))
    feat = rng.randn(B, N, C).astype(np.float32)
    labels = rng.randint(0, 4, (B, N)).astype(np.int32)
    table = (rng.randn(4, E) * 0.5).astype(np.float32)
    w = (rng.randn(125, C + E, 32) * 0.1).astype(np.float32)
    gout = rng.randn(B, N, 32).astype(np.float32)

    def jfn(f, w_, t_):
        return jsparse.subm_conv_apply(f, jn, w_,
                                       categorical=(jnp.asarray(labels), t_))
    _, vjp = jax.vjp(jfn, jnp.asarray(feat), jnp.asarray(w),
                     jnp.asarray(table))
    jdf, jdw, jdt = vjp(jnp.asarray(gout))
    ft, wt, tt = (T(a).requires_grad_() for a in (feat, w, table))
    sparse_conv.subm_conv_apply(ft, nm, wt, categorical=(T(labels), tt)
                                ).backward(T(gout))
    _close(ft.grad, jdf, "dfeat")
    _close(wt.grad, jdw, "dW")
    _close(tt.grad, jdt, "dtable")
    assert np.abs(np.asarray(jdf)).max() > 0.1


# ------------------------------------------------------------ K10's plan --

def _emulate_k10(g, idx, n, ranges, window):
    """K10 as csrc/gather_smallc.cu runs the plan, in numpy: block (r, b, s)
    adds the g rows of range r whose index falls in slab s into its own
    (window, C) copy, which it writes once (into dx when ranges == 1,
    else into partial r); the partials add in order r = 0, 1, ... Returns
    dx and the count of reads of each (cloud, row, channel) of g per slab
    and of writes of each (range, cloud, dx row, channel)."""
    B, M, C = g.shape
    slabs = [(d0, min(n, d0 + window)) for d0 in range(0, n, window)]
    reads = np.zeros((len(slabs), B, M, C), np.int32)
    writes = np.zeros((ranges, B, n, C), np.int32)
    parts = np.zeros((ranges, B, n, C), np.float32)
    for r, (m0, m1) in enumerate(gather.scatter_smallc_ranges(M, ranges)):
        for b in range(B):
            for s, (d0, d1) in enumerate(slabs):
                copy = np.zeros((d1 - d0, C), np.float32)
                reads[s, b, m0:m1] += 1
                rows = np.arange(m0, m1)
                i = idx[b, m0:m1].astype(np.int64) - d0
                keep = (i >= 0) & (i < d1 - d0)
                np.add.at(copy, i[keep], g[b, rows[keep]])
                parts[r, b, d0:d1] = copy
                writes[r, b, d0:d1] += 1
    dx = parts[0].copy()
    for r in range(1, ranges):
        dx += parts[r]
    return dx, reads, writes


@pytest.mark.parametrize("ranges,window", [(1, 300), (3, 300), (3, 100),
                                           (7, 64), (2, 7), (1, 1)])
@pytest.mark.parametrize("C,dtype", [(5, np.int32), (7, np.int64),
                                     (20, np.int32)])
def test_k10_plan_emulated_matches_plain(ranges, window, C, dtype):
    """Every plan the wrapper may be forced to (the card tests force the
    same ones): each g element read once per slab, each dx element written
    once per range, and the in-order sum of the partials equal to the
    plain scatter-add (sentinel, negative and colliding indices)."""
    rng = np.random.RandomState(C + ranges)
    B, n = 2, 300
    M = 7 * gather.SMALLC_TILE_ROWS + 5           # a ragged last tile
    idx = rng.randint(0, n, (B, M)).astype(dtype)
    idx[rng.rand(B, M) < 0.2] = n
    idx[:, :5] = [-1, -7, n + 3, 0, 0]
    idx[1, 100:400] = 17                           # one hot row
    g = rng.randn(B, M, C).astype(np.float32)
    dx, reads, writes = _emulate_k10(g, idx, n, ranges, window)
    assert (reads == 1).all() and (writes == 1).all()
    _close(dx, gather.scatter_rows_smallc_add_plain(T(g), T(idx), n),
           "in-order sum of the partials")


@pytest.mark.parametrize("B,M,n,C", [
    (32, 512000, 4096, 5), (32, 512000, 4096, 7), (32, 512000, 4096, 20),
    (32, 512000, 4096, 32), (1, 512000, 4096, 5), (32, 4096, 4096, 7),
    (4, 4096, 4096, 4), (2, 125005, 1024, 32), (3, 0, 300, 5), (1, 10, 1, 1),
    (2, 50000, 200000, 3)])
def test_k10_plan_covers_every_row_and_channel_once(B, M, n, C):
    ranges, window = gather.scatter_smallc_plan(B, M, n, C)
    assert gather.scatter_smallc_smem(C, window) <= gather.SMALLC_SMEM
    slabs = -(-n // window)
    cover = np.zeros(n, np.int32)
    for d0 in range(0, n, window):
        cover[d0:d0 + window] += 1
    assert (cover == 1).all()
    # as few slabs as the shared memory allows
    if slabs > 1:
        assert gather.scatter_smallc_smem(C, -(-n // (slabs - 1))) > \
            gather.SMALLC_SMEM
    T_ = gather.SMALLC_TILE_ROWS
    runs = gather.scatter_smallc_ranges(M, ranges)
    assert [m0 for m0, _ in runs[1:]] == [m1 for _, m1 in runs[:-1]]
    assert runs[0][0] == 0 and runs[-1][1] == M
    assert all(m0 % T_ == 0 for m0, _ in runs)
    assert all(m0 < m1 for m0, m1 in runs) or M == 0
    blocks = ranges * B * slabs
    # the SMs about full: one more range per cloud would overfill them,
    # unless the tiles or the partials' bytes cap the ranges
    fill = gather.SMALLC_SMS * gather.scatter_smallc_blocks_per_sm(C, window)
    assert blocks <= fill or ranges == 1
    assert (ranges + 1) * B * slabs > fill or \
        ranges == -(-M // T_) or ranges == max(1, M // (2 * n))
    assert ranges == 1 or ranges * n <= M // 2


def test_k10_release_plans():
    """The motion planner's training stem (C = 5) and the policy's stem
    input gradient (C = 7): one slab (80 and 112 KB, two blocks an SM),
    8 ranges a cloud, 256 blocks; chip_smoke's C = 20 case: 2 slabs of
    2048 rows (160 KB, one block an SM), 2 ranges; a B = 1 stem: 62
    ranges (M / 2n)."""
    assert gather.scatter_smallc_plan(32, 512000, 4096, 5) == (8, 4096)
    assert gather.scatter_smallc_plan(32, 512000, 4096, 7) == (8, 4096)
    assert gather.scatter_smallc_blocks_per_sm(7, 4096) == 2
    assert gather.scatter_smallc_blocks_per_sm(20, 2048) == 1
    assert gather.scatter_smallc_plan(32, 512000, 4096, 20) == (2, 2048)
    assert gather.scatter_smallc_plan(1, 512000, 4096, 5) == (62, 4096)
    assert gather.scatter_smallc_smem(5, 4096) == 81920
    assert gather.scatter_smallc_smem(7, 4096) == 114688


# ------------------------------------------------------------- at bf16 ----
# ptv3_config compute_dtype bfloat16: K10's bf16 path sums the bf16
# cotangent rows in fp32 and rounds dx to bf16 once, as pallas_gather.py
# `_smallc_op_bwd` does; held within the one-rounding bar of ops/bf16.py
# (one bf16 ulp of the value + 1e-4 of the gradient's own scale) against
# the Pallas VJPs in interpret mode, and within XLA_DX_BAR against the XLA
# conv's VJP (which rounds each tap's product and adds the taps in a bf16
# carry; tests/test_torch_port_bf16_train.py states it).

@pytest.mark.parametrize("C,dtype", [(5, np.int32), (7, np.int64),
                                     (20, np.int32)])
def test_k10_plain_bf16_matches_pallas_vjp(C, dtype):
    """K10's plain version at bf16 (fp32 sums, one rounding) against
    jax.vjp of the JAX gather_rows_smallc (`_smallc_op`, its backward
    `_smallc_bwd_call` in interpret mode) at bf16: 1024 rows onto 256, a
    fifth of them sentinels (N, N + 3, -1), 300 of them on one row; the
    autograd path (K9's backward) equal to the direct call."""
    rng = np.random.RandomState(C)
    B, N, M = 2, 256, 1024
    idx = rng.randint(0, N, (B, M)).astype(dtype)
    idx[rng.rand(B, M) < 0.2] = N
    idx[:, :3] = [N + 3, -1, 0]
    idx[1, 200:500] = 17
    x = rng.randn(B, N, C).astype(np.float32)
    g = rng.randn(B, M, C).astype(np.float32)
    got = gather.scatter_rows_smallc_add(tbf(g), T(idx), N)
    assert got.dtype == torch.bfloat16
    want = jrun(lambda a, gg: jax.vjp(lambda t: jgather.gather_rows_smallc(
        t, jnp.asarray(idx), interpret=True), a)[1](gg)[0], jbf(x), jbf(g))
    within_bar(got, want, what="K10 bf16 vs Pallas")
    xt = tbf(x).requires_grad_()
    gather.gather_rows_smallc(xt, T(idx)).backward(tbf(g))
    assert torch.equal(xt.grad.view(torch.int16), got.view(torch.int16))
    assert np.abs(f32(want)).max() > 1.0


def test_stem_input_grad_bf16_matches_jax_pallas_interpret(release_stem):
    """The policy stem at bf16 (x, W and the cotangent bf16): dx (G = g W^T
    summed in fp32 and rounded to bf16 per (row, tap), then K10's plain
    version: fp32 sums, one rounding) against jax.vjp of the windowed
    Pallas stem at bf16 on its near links (with_far=False), whose feature
    gradient is then `_windowed_gather_bwd` alone: the einsum's VJP
    rounds G where the port does and `_smallc_bwd_call` sums in fp32 and
    casts once, so within the one-rounding bar. (With far links JAX adds
    a second rounding: their rows' gather VJP scatter-adds in bf16 and the
    two parts meet in a bf16 add.) The port runs the same near links: the
    live links whose windowed row is not zero (every feature is). dW (K7's
    plain version, one rounding) within the bar of the XLA stencil
    product's."""
    nm, feat, w, gout, _, _, _ = release_stem
    assert (feat != 0).all()
    jw = jbf(w)

    def windowed(f):
        g, _ = jstem.stem_gather_windowed(f, nm, interpret=True,
                                          with_far=False)
        o = jnp.einsum("bnkc,kcd->bnd", jnp.where(nm.ok[..., None], g, 0.0),
                       jw, preferred_element_type=jnp.float32)
        return o.astype(jnp.bfloat16), g

    def run(f, gg):
        _, vjp, g = jax.vjp(windowed, f, has_aux=True)
        return vjp(gg)[0], g

    jdx, rows = jrun(run, jbf(feat), jbf(gout))
    assert jdx.dtype == jnp.bfloat16
    ok = np.asarray(nm.ok)
    near = ok & (f32(rows) != 0).any(-1)
    assert 0 < (ok & ~near).sum() < 0.1 * ok.sum()
    xt, wt = tbf(feat).requires_grad_(), tbf(w).requires_grad_()
    out = stem.stem_conv(xt, T(np.asarray(nm.idx)), T(near), wt)
    assert out.dtype == torch.bfloat16
    out.backward(tbf(gout))
    assert xt.grad.dtype == torch.bfloat16
    within_bar(xt.grad, jdx, what="bf16 dx vs the windowed stem")
    xw = tbf(w).requires_grad_()
    stem.stem_conv(tbf(feat), T(np.asarray(nm.idx)), T(ok), xw).backward(
        tbf(gout))
    _, vjp = jax.vjp(lambda ww: jsparse.subm_conv_apply(jbf(feat), nm, ww)
                     .astype(jnp.bfloat16), jw)
    within_bar(xw.grad, vjp(jbf(gout))[0], what="bf16 dW vs XLA")


@pytest.mark.parametrize("interpret", [False, True])
def test_categorical_stem_feature_grad_bf16_matches_jax(monkeypatch,
                                                        interpret):
    """The motion planner's stem at bf16 with its features requiring a
    gradient: dfeat (the product's VJP rounded to bf16 per gathered row,
    then K10's bf16 plain version) against jax.vjp of the JAX
    subm_conv_apply at bf16 on its K9 path in interpret mode (the same
    rounding points: the one-rounding bar, the label table's gradient
    too) and on its XLA path (XLA_DX_BAR for both: the streaming conv's
    VJP adds its taps in a bf16 carry); dW within the bar."""
    monkeypatch.setattr(jsparse, "_SMALLC_INTERPRET", interpret)
    rng = np.random.RandomState(6)
    B, N, C, E = 2, 256, 4, 16
    gc = rng.randint(0, 9, (B, N, 3)).astype(np.int32)
    mask = np.arange(N)[None] < np.array([[N], [N - 40]])
    jn = jsparse.build_neighbor_map(jnp.asarray(gc), jnp.asarray(mask), 5, 4,
                                    extent=16)
    nm = sparse_conv.NeighborMap(T(jn.idx), T(jn.ok))
    feat = rng.randn(B, N, C).astype(np.float32)
    labels = rng.randint(0, 4, (B, N)).astype(np.int32)
    table = (rng.randn(4, E) * 0.5).astype(np.float32)
    w = (rng.randn(125, C + E, 32) * 0.1).astype(np.float32)
    gout = rng.randn(B, N, 32).astype(np.float32)

    def jfn(f, w_, t_):
        return jsparse.subm_conv_apply(
            f, jn, w_, categorical=(jnp.asarray(labels), t_)).astype(
                jnp.bfloat16)

    def run(f, w_, t_, gg):
        return jax.vjp(jfn, f, w_, t_)[1](gg)

    jdf, jdw, jdt = jrun(run, jbf(feat), jbf(w), jbf(table), jbf(gout))
    ft, wt, tt = (tbf(a).requires_grad_() for a in (feat, w, table))
    out = sparse_conv.subm_conv_apply(ft, nm, wt, categorical=(T(labels), tt))
    assert out.dtype == torch.bfloat16
    out.backward(tbf(gout))
    assert ft.grad.dtype == torch.bfloat16
    if interpret:
        within_bar(ft.grad, jdf, what="bf16 dfeat vs the K9 path")
        within_bar(tt.grad, jdt, what="bf16 dtable")
    else:
        within(ft.grad, jdf, XLA_DX_BAR, "bf16 dfeat vs XLA")
        within(tt.grad, jdt, XLA_DX_BAR, "bf16 dtable vs XLA")
    within_bar(wt.grad, jdw, what="bf16 dW")
    assert np.abs(f32(jdf)).max() > 0.1
