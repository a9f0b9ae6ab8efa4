"""The PyTorch port on a CUDA card: each kernel (K1-K10) against its plain
version, the gathers' direct and autograd paths, the launch stream, the
card's grid coordinates against the host presort's, and the data path's
device parts: the fixed-capacity voxelizer and the fused preprocess
against the CPU (and the voxelizer bit-equal across launches), and
PrefetchToDevice onto the card.
Tolerance 1e-4 * max(1, max|plain|): fp32 on both sides, other summation
orders (K10's shared-memory atomics in a run-dependent one); the gathers
K4 and K9 only copy and must be bit-equal, and K8, which adds each
destination's sources in increasing row order, must equal that order's
PyTorch emulation (gather.scatter_rows_add_ordered) bit for bit.

Every case carries the `gpu` marker and skips without a card. The file
imports neither jax nor the JAX package, so it runs on a machine that has
only the port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""
import numpy as np
import pytest
import torch

from robot3dlotus_tpu_torch.configs.rlbench.constants import \
    get_robot_workspace
from robot3dlotus_tpu_torch.models.ptv3 import compute_grid_coord
from robot3dlotus_tpu_torch.ops import attention, conv, cuda_lib, gather, stem
from robot3dlotus_tpu_torch.ops.bf16 import bf16_excess
from robot3dlotus_tpu_torch.ops.eval_preprocess import device_preprocess
from robot3dlotus_tpu_torch.ops.sparse_conv import build_neighbor_map
from robot3dlotus_tpu_torch.ops.voxel import voxelize_fixed
from robot3dlotus_tpu_torch.train.datasets.loader import PrefetchToDevice

pytestmark = pytest.mark.gpu
TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cloud(rng, B=2, N=512, span=24):
    gc = rng.randint(0, span, (B, N, 3)).astype(np.int32)
    mask = np.arange(N)[None] < np.array([[N], [N - 77]])
    return torch.from_numpy(gc), torch.from_numpy(mask)


def _check(got, want):
    got, want = got.detach(), want.detach()
    torch.cuda.synchronize()
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= TOL * scale


@pytest.mark.parametrize("Dh", [8, 16, 24, 32])
@pytest.mark.parametrize("P", [128, 48, 37])
@pytest.mark.parametrize("G,H", [(32, 2), (2, 32), (128, 2)])
def test_k1_patch_attention(dev, G, H, P, Dh):
    """K1 at B = 1 ((32, 2): stage 0; (2, 32): stage 4) and B = 4 patch
    counts, ragged P, patch 0 with no valid key: the wrapper's query split
    and every split forced (1, 2, 4, 8 warps a block) within the bar of the
    plain version, bit-equal across two launches and across splits (each
    query row's arithmetic does not depend on its block)."""
    g = torch.Generator().manual_seed(G + P + Dh)
    q, k, v = (torch.randn(G, H, P, Dh, generator=g).to(dev)
               for _ in range(3))
    kv = (torch.rand(G, P, generator=g) > 0.2).to(dev)
    kv[0] = False                      # fully masked: uniform weights
    args = (q, k, v, kv, Dh ** -0.5)
    got = _twice(lambda: attention.patch_attention(*args), "patch_attention")
    want = attention.patch_attention_plain(*args)
    _check(got, want)
    _check(got[0], v[0].mean(1, keepdim=True).expand(H, P, Dh))
    groups = -(-P // 16)
    for warps in (1, 2, 4, 8):
        split = attention.patch_attention_split(*args, warps,
                                                -(-groups // warps))
        assert torch.equal(split, got)


@pytest.mark.parametrize("C", [64, 256, 768])
def test_k2_subm_conv(dev, C):
    rng = np.random.RandomState(1)
    gc, mask = _cloud(rng)
    nm = build_neighbor_map(gc.to(dev), mask.to(dev), 3, 5, extent=128)
    x = torch.from_numpy(rng.randn(2, 512, C).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(27, C, C) * 0.05).astype(np.float32))
    b = torch.from_numpy(rng.randn(C).astype(np.float32))
    args = (x, nm.idx, nm.ok, w.to(dev), b.to(dev))
    _check(conv.subm_conv(*args), conv.subm_conv_plain(*args))


def _stem_map(rng, dev, kind, B, N):
    """A (B, N, 125) map: 'none' no live link, 'one' a single one (row N - 1
    of the last cloud, tap 3, onto row 5), 'all' every link live onto random
    rows, 'release' the k = 5 neighbours of a cloud of voxels on a table
    and a box, rows sorted by coordinate as a serialized cloud's are."""
    K = 125
    if kind == "release":
        pts = np.concatenate([
            np.stack([rng.randint(0, 60, N), rng.randint(0, 60, N),
                      np.zeros(N, int)], -1),
            np.stack([rng.randint(20, 30, N), rng.randint(20, 30, N),
                      rng.randint(0, 25, N)], -1)])
        clouds = [pts[rng.permutation(len(pts))[:N]] for _ in range(B)]
        gc = np.stack([c[np.lexsort(c.T[::-1])] for c in clouds]).astype(
            np.int32)             # rows in (x, y, z) order
        mask = np.ones((B, N), bool)
        mask[-1, N - 50:] = False
        nm = build_neighbor_map(torch.from_numpy(gc).to(dev),
                                torch.from_numpy(mask).to(dev), 5, 7,
                                extent=128)
        return nm.idx, nm.ok
    idx = torch.from_numpy(rng.randint(0, N, (B, N, K)).astype(np.int32))
    ok = torch.zeros(B, N, K, dtype=torch.bool)
    if kind == "all":
        ok[:] = True
    elif kind == "one":
        ok[-1, N - 1, 3] = True
        idx[-1, N - 1, 3] = 5
    return idx.to(dev), ok.to(dev)


@pytest.mark.parametrize("kind", ["none", "one", "all", "release"])
@pytest.mark.parametrize("cin,cout", [(7, 64), (8, 64), (7, 48), (8, 48)])
@pytest.mark.parametrize("B", [1, 4, 32])
def test_k3_stem_conv(dev, B, cin, cout, kind):
    """K3 at the B = 1 (tap ranges), B = 4 and B = 32 (training: 8-warp
    blocks, one range) plans of 4096-point clouds, on maps with no live
    link, one, all and a release-like one: within the bar of the plain
    version and bit-equal across two launches, one count per call."""
    rng = np.random.RandomState(B + cin + cout)
    N = 4096
    idx, ok = _stem_map(rng, dev, kind, B, N)
    x = _randn(rng, dev, B, N, cin)
    w = _randn(rng, dev, 125, cin, cout, scale=0.1)
    got = _twice(lambda: stem.stem_conv(x, idx, ok, w), "stem_conv")
    _check(got, stem.stem_conv_plain(x, idx, ok, w))
    if kind == "none":
        assert not got.any()


@pytest.mark.parametrize("cols,warps,splits,blocks", [
    (64, 1, 1, 125), (64, 2, 8, 63), (64, 4, 3, 32), (32, 8, 5, 16),
    (64, 16, 1, 3), (32, 16, 1, 132)])
def test_k3_stem_conv_plans(dev, cols, warps, splits, blocks):
    """K3 with each plan forced (ops/stem.py stem_conv_plan's fields): block
    shapes, tap-range counts, 32 and 64 columns a block, and few blocks
    whose warps walk many row groups; on a release-like map of 2 clouds x
    1000 points (a 16-row group that straddles the two clouds) and Cout =
    68 (a ragged last column tile)."""
    rng = np.random.RandomState(warps * 17 + splits + cols)
    idx, ok = _stem_map(rng, dev, "release", 2, 1000)
    x = _randn(rng, dev, 2, 1000, 7)
    w = _randn(rng, dev, 125, 7, 68, scale=0.1)
    _check(stem.stem_conv_split(x, idx, ok, w, cols, warps, splits, blocks),
           stem.stem_conv_plain(x, idx, ok, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_k3_rows_at_b1_equal_rows_in_b4(dev, dtype):
    """A row's order of sums does not follow B (ops/stem.py
    stem_sum_ranges, ops/conv.py conv_tap_splits): cloud 2's rows at B = 1
    equal its rows in a B = 4 batch bit for bit, and in the batch with the
    whole row in one block (K3 splits 1, K2 one range), for K3 (1000-point
    clouds: 16-row groups straddle clouds) and K2 (a CPE conv, 27 taps x
    64, and the Concat stem, 125 taps x 264)."""
    rng = np.random.RandomState(2121)
    B, N, one = 4, 1000, slice(2, 3)
    idx, ok = _stem_map(rng, dev, "release", B, N)
    x = _randn(rng, dev, B, N, 7).to(dtype)
    w = _randn(rng, dev, 125, 7, 64, scale=0.1).to(dtype)
    batch = stem.stem_conv(x, idx, ok, w)
    alone = stem.stem_conv(x[one].contiguous(), idx[one].contiguous(),
                           ok[one].contiguous(), w)
    cols, warps, _, blocks = stem.stem_conv_plan(B, N, 125, 7, 64,
                                                 dtype == BF16)
    whole = stem.stem_conv_split(x, idx, ok, w, cols, warps, 1, blocks)
    torch.cuda.synchronize()
    assert torch.equal(alone[0], batch[2]) and torch.equal(batch, whole)
    for K, cin, cout in ((27, 64, 64), (125, 264, 64)):
        idx2 = torch.from_numpy(rng.randint(0, N, (B, N, K)).astype(
            np.int32)).to(dev)
        ok2 = torch.from_numpy(rng.rand(B, N, K) < 0.2).to(dev)
        x2 = _randn(rng, dev, B, N, cin).to(dtype)
        w2 = _randn(rng, dev, K, cin, cout, scale=0.05).to(dtype)
        bias = _randn(rng, dev, cout, scale=0.1)
        assert conv.conv_tap_splits(1, N, K, cout) == K
        batch = conv.subm_conv(x2, idx2, ok2, w2, bias)
        alone = conv.subm_conv(x2[one].contiguous(), idx2[one].contiguous(),
                               ok2[one].contiguous(), w2, bias)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], batch[2]), (K, dtype)


def _sentinel_idx(rng, B, M, N, dtype):
    """(B, M) indices in [0, N) with a fifth at the sentinel N and a few
    other values outside [0, N)."""
    idx = rng.randint(0, N, (B, M))
    idx[rng.rand(B, M) < 0.2] = N
    idx[:, :3] = [-1, N + 9, -5]
    return torch.from_numpy(idx).to(dtype)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("D", [7, 64, 96, 768])
def test_k4_gather_rows(dev, D, dtype):
    """Bit-equal to the plain version with sentinel rows, int32 and int64
    indices, on B * M rows that fill no whole number of row tiles."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(3, 257, D).astype(np.float32)).to(dev)
    idx = _sentinel_idx(rng, 3, 1021, 257, dtype).to(dev)
    got = gather.gather_rows(x, idx)
    assert torch.equal(got, gather.gather_rows_plain(x, idx))
    assert not got[(idx < 0) | (idx >= 257)].any()


@pytest.mark.parametrize("D", [64, 7])
def test_k4_gather_rows_unaligned_view(dev, D):
    """x a contiguous view 4 bytes past a 16-byte boundary: the kernel takes
    its 4-byte path and stays bit-equal."""
    rng = np.random.RandomState(13)
    flat = torch.from_numpy(rng.randn(2 * 100 * D + 1).astype(np.float32))
    x = flat.to(dev)[1:].view(2, 100, D)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    idx = _sentinel_idx(rng, 2, 333, 100, torch.int64).to(dev)
    assert torch.equal(gather.gather_rows(x, idx),
                       gather.gather_rows_plain(x, idx))


def test_k4_direct_and_autograd_paths(dev):
    """A call that carries no gradient launches K4 directly; one that does
    goes through the autograd Function: the same forward, and its backward
    launches K8, which drops the sentinel rows' cotangents."""
    rng = np.random.RandomState(14)
    x = torch.from_numpy(rng.randn(2, 300, 64).astype(np.float32)).to(dev)
    idx = _sentinel_idx(rng, 2, 900, 300, torch.int64).to(dev)
    g = torch.from_numpy(rng.randn(2, 900, 64).astype(np.float32)).to(dev)
    with torch.no_grad():
        direct = gather.gather_rows(x.clone().requires_grad_(), idx)
    assert direct.grad_fn is None
    plain_direct = gather.gather_rows(x, idx)
    assert plain_direct.grad_fn is None
    xr = x.clone().requires_grad_()
    before = dict(cuda_lib.LAUNCHES)
    out = gather.gather_rows(xr, idx)
    assert out.grad_fn is not None
    assert cuda_lib.LAUNCHES["gather_rows"] == before["gather_rows"] + 1
    assert torch.equal(out, direct) and torch.equal(out, plain_direct)
    out.backward(g)
    assert cuda_lib.LAUNCHES["scatter_rows_add"] == \
        before["scatter_rows_add"] + 1
    _check(xr.grad, gather.scatter_rows_add_plain(g, idx, 300))


def test_launch_uses_the_current_stream(dev):
    """cuda_lib.current_stream is torch.cuda.current_stream().cuda_stream on
    the default stream and inside a side stream's context, where a launch
    runs in order with that stream's work."""
    def raw():
        return cuda_lib.current_stream().value or 0
    assert raw() == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    x = torch.randn(2, 128, 64, device=dev)
    idx = torch.randint(0, 128, (2, 500), device=dev)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert raw() == side.cuda_stream
        y = x * 2.0
        got = gather.gather_rows(y, idx)
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(got, gather.gather_rows_plain(x * 2.0, idx))


def _check_rel(got, want):
    """|got - want| <= 1e-4 * max|want|: gradients are held against their
    own scale, which is far below 1 in training."""
    got, want = got.detach(), want.detach()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


def _attn_dropout_inputs(dev, G, H, P, Dh, seed=5):
    g = torch.Generator().manual_seed(seed)
    q, k, v, gout = (torch.randn(G, H, P, Dh, generator=g).to(dev)
                     for _ in range(4))
    kv = (torch.rand(G, P, generator=g) > 0.2).to(dev)
    kv[0] = False                      # no valid key: uniform weights
    return q, k, v, kv, gout


@pytest.mark.parametrize("Dh", [8, 16, 24, 32])
@pytest.mark.parametrize("P", [128, 48, 37])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_k5_k6_attention_dropout(dev, rate, P, Dh):
    """K5's out, lse and packed bits against its plain version (bits
    bit-equal, and equal to philox_keep_mask); K6's dq, dk, dv from K5's
    outputs against its plain version. Patch 0 has no valid key; P = 37
    leaves ragged 8-row tiles and rows that start inside a generator
    call."""
    G, H, seed, scale = 6, 3, 123456789, Dh ** -0.5
    q, k, v, kv, gout = _attn_dropout_inputs(dev, G, H, P, Dh)
    out, lse, bits = attention.patch_attention_dropout_fwd(
        q, k, v, kv, scale, rate, seed)
    p_out, p_lse, p_bits = attention.patch_attention_dropout_fwd_plain(
        q, k, v, kv, scale, rate, seed)
    assert torch.equal(bits, p_bits)
    assert torch.equal(attention.unpack_keep_bits(bits.cpu(), P),
                       attention.philox_keep_mask(seed, G, H, P, rate))
    _check(out, p_out)
    assert bool((lse[0] == -1e9).all()) and bool((p_lse[0] == -1e9).all())
    _check(lse[1:], p_lse[1:])
    got = attention.patch_attention_dropout_bwd(
        q, k, v, kv, out, lse, bits, gout, scale, rate)
    want = attention.patch_attention_dropout_bwd_plain(
        q, k, v, kv, out, lse, bits, gout, scale, rate)
    for a, b in zip(got, want):
        _check_rel(a, b)


def test_k5_k6_autograd_launches(dev):
    """patch_attention_dropout's autograd path launches K5 once and K6
    once, and its gradients are the recomputing plain backward's with
    philox_keep_mask (an oracle that reads nothing K5 wrote)."""
    G, H, P, Dh, rate, seed = 8, 4, 128, 32, 0.1, 99
    q, k, v, kv, gout = _attn_dropout_inputs(dev, G, H, P, Dh, seed=8)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    cuda_lib.reset_launches()
    out = attention.patch_attention_dropout(qr, kr, vr, kv, 0.2, rate, seed)
    out.backward(gout)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["patch_attention_dropout"] == 1
    assert cuda_lib.LAUNCHES["patch_attention_dropout_bwd"] == 1
    keep = attention.philox_keep_mask(seed, G, H, P, rate, dev)
    _check(out, attention.patch_attention_dropout_plain(
        q, k, v, kv, 0.2, rate, keep))
    want = attention.patch_attention_dropout_vjp_plain(
        q, k, v, kv, 0.2, rate, keep, gout)
    for got, w in zip((qr.grad, kr.grad, vr.grad), want):
        _check_rel(got, w)


def test_k5_rate0_matches_k1(dev):
    """K5 at rate 0 against K1, K6 at rate 0 against the plain version's
    gradient, and K1 (no backward) refusing a call that needs one."""
    g = torch.Generator().manual_seed(6)
    q, k, v, gout = (torch.randn(8, 4, 128, 32, generator=g).to(dev)
                     for _ in range(4))
    kv = (torch.rand(8, 128, generator=g) > 0.3).to(dev)
    _check(attention.patch_attention_dropout(q, k, v, kv, 0.2, 0.0, 7),
           attention.patch_attention(q, k, v, kv, 0.2))
    with pytest.raises(RuntimeError, match="no backward"):
        attention.patch_attention(q.clone().requires_grad_(), k, v, kv, 0.2)
    grads = []
    for d in (dev, torch.device("cpu")):
        ts = [t.detach().to(d).requires_grad_() for t in (q, k, v)]
        attention.patch_attention_dropout(*ts, kv.to(d), 0.2, 0.0, 7
                                          ).backward(gout.to(d))
        grads.append([t.grad for t in ts])
    for got, want in zip(*grads):
        _check(got.cpu(), want)


@pytest.mark.parametrize("K,cin,cout", [(27, 64, 64), (27, 256, 128),
                                        (125, 7, 64)])
def test_k7_conv_weight_grad(dev, K, cin, cout):
    """K7 at a CPE shape and at the stem's shape (K = 125, Cin 7)."""
    rng = np.random.RandomState(7)
    gc, mask = _cloud(rng)
    nm = build_neighbor_map(gc.to(dev), mask.to(dev), round(K ** (1 / 3)),
                            5, extent=128)
    x = torch.from_numpy(rng.randn(2, 512, cin).astype(np.float32)).to(dev)
    gout = torch.from_numpy(rng.randn(2, 512, cout).astype(np.float32))
    args = (x, nm.idx, nm.ok, gout.to(dev))
    _check(conv.conv_weight_grad(*args), conv.conv_weight_grad_plain(*args))


def test_k2_k8_conv_dx_and_stem_dw(dev):
    """subm_conv / stem_conv autograd on the card (dx: K8 then the
    mirrored K2; dW: K7) against the plain versions' autograd, on a map
    with duplicate voxels."""
    rng = np.random.RandomState(8)
    gc, mask = _cloud(rng, span=10)
    for ks, cin, cout, bias in ((3, 64, 128, True), (5, 7, 64, False)):
        nm = build_neighbor_map(gc.to(dev), mask.to(dev), ks, 5, extent=128)
        x = torch.from_numpy(rng.randn(2, 512, cin).astype(np.float32))
        w = torch.from_numpy((rng.randn(ks ** 3, cin, cout) * 0.05)
                             .astype(np.float32))
        b = torch.from_numpy(rng.randn(cout).astype(np.float32)) \
            if bias else None
        gout = torch.from_numpy(rng.randn(2, 512, cout).astype(np.float32))
        grads = []
        for d in (dev, torch.device("cpu")):
            xs = x.to(d).requires_grad_(bias)
            ws = w.to(d).requires_grad_()
            bs = b.to(d).requires_grad_() if bias else None
            if bias:
                out = conv.subm_conv(xs, nm.idx.to(d), nm.ok.to(d), ws, bs)
                out.backward(gout.to(d))
                grads.append((xs.grad, ws.grad, bs.grad))
            else:
                out = stem.stem_conv(xs, nm.idx.to(d), nm.ok.to(d), ws)
                out.backward(gout.to(d))
                grads.append((ws.grad,))
        for got, want in zip(*grads):
            _check(got.cpu(), want)


# K2 / K7 on the tensor cores: every release CPE width and two Cin != Cout
CONV_SHAPES = [(64, 64), (128, 128), (256, 256), (512, 512), (768, 768),
               (128, 256), (256, 128)]


def _conv_map(rng, dev, B, N, span):
    gc = rng.randint(0, span, (B, N, 3)).astype(np.int32)
    mask = np.arange(N)[None] < np.array([[N], [N - 77]])[:B]
    return build_neighbor_map(torch.from_numpy(gc).to(dev),
                              torch.from_numpy(mask).to(dev), 3, 5,
                              extent=128)


def _randn(rng, dev, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(
        np.float32)).to(dev)


def _twice(fn, kernel):
    """fn() twice on the same inputs: bit-equal, and one launch counted
    per wrapper call."""
    before = cuda_lib.LAUNCHES[kernel]
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[kernel] == before + 2
    assert torch.equal(a, b)
    return a


@pytest.mark.parametrize("cin,cout", CONV_SHAPES)
@pytest.mark.parametrize("B,N", [(1, 256), (2, 300)])
def test_k2_k7_tensor_core_convs(dev, B, N, cin, cout):
    """K2 forward, K2 on the mirrored weight (the dx launch) and K7 at
    B = 1 with N = 256 (stage 4's rows: the tap-split path) and at B = 2
    with N % 64 != 0: within the bar of the plain versions, bit-equal
    across two launches, one count per wrapper call."""
    rng = np.random.RandomState(cin + 3 * cout + N)
    nm = _conv_map(rng, dev, B, N, 12)
    x = _randn(rng, dev, B, N, cin)
    w = _randn(rng, dev, 27, cin, cout, scale=cin ** -0.5)
    b = _randn(rng, dev, cout)
    g = _randn(rng, dev, B, N, cout)
    out = _twice(lambda: conv.subm_conv(x, nm.idx, nm.ok, w, b), "subm_conv")
    _check(out, conv.subm_conv_plain(x, nm.idx, nm.ok, w, b))
    wm = conv.mirror_weight(w)
    dx = _twice(lambda: conv.subm_conv(g, nm.idx, nm.ok, wm), "subm_conv")
    _check(dx, conv.subm_conv_plain(g, nm.idx, nm.ok, wm))
    dw = _twice(lambda: conv.conv_weight_grad(x, nm.idx, nm.ok, g),
                "conv_weight_grad")
    _check(dw, conv.conv_weight_grad_plain(x, nm.idx, nm.ok, g))


@pytest.mark.parametrize("B,N,C", [(32, 2304, 128), (8, 4096, 64)])
def test_k2_k7_long_sums(dev, B, N, C):
    """K7's sums over tens of thousands of rows and K2's over 27 taps at a
    training step's row count, within 1e-4 of the plain version's largest
    value (the bar chip_smoke.py holds the captured gradients to)."""
    rng = np.random.RandomState(B + N + C)
    gc = rng.randint(0, 40, (B, N, 3)).astype(np.int32)
    nm = build_neighbor_map(torch.from_numpy(gc).to(dev),
                            torch.ones(B, N, dtype=torch.bool, device=dev),
                            3, 6, extent=128)
    x = _randn(rng, dev, B, N, C)
    w = _randn(rng, dev, 27, C, C, scale=C ** -0.5)
    g = _randn(rng, dev, B, N, C)
    for got, want in ((conv.conv_weight_grad(x, nm.idx, nm.ok, g),
                       conv.conv_weight_grad_plain(x, nm.idx, nm.ok, g)),
                      (conv.subm_conv(x, nm.idx, nm.ok, w),
                       conv.subm_conv_plain(x, nm.idx, nm.ok, w))):
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= \
            TOL * float(want.abs().max())


@pytest.mark.parametrize("kind", ["none", "one", "duplicates"])
def test_k2_k7_edge_maps(dev, kind):
    """A map with no live link, one with a single live link (row 200 of
    cloud 1, the centre tap onto itself) and one with many duplicate
    voxels: K2, K7 and the autograd dx (K8 onto owners, mirrored K2)
    against the plain versions' autograd on the card."""
    B, N, cin, cout = 2, 300, 64, 128
    rng = np.random.RandomState(13)
    if kind == "duplicates":
        nm = _conv_map(rng, dev, B, N, 4)
        idx, ok = nm.idx, nm.ok
    else:
        idx = torch.from_numpy(rng.randint(0, N, (B, N, 27)).astype(
            np.int32)).to(dev)
        ok = torch.zeros(B, N, 27, dtype=torch.bool, device=dev)
        if kind == "one":
            ok[1, 200, 13] = True
            idx[1, 200, 13] = 200
    x = _randn(rng, dev, B, N, cin)
    w = _randn(rng, dev, 27, cin, cout, scale=cin ** -0.5)
    b = _randn(rng, dev, cout)
    g = _randn(rng, dev, B, N, cout)
    out = _twice(lambda: conv.subm_conv(x, idx, ok, w, b), "subm_conv")
    _check(out, conv.subm_conv_plain(x, idx, ok, w, b))
    dw = _twice(lambda: conv.conv_weight_grad(x, idx, ok, g),
                "conv_weight_grad")
    _check(dw, conv.conv_weight_grad_plain(x, idx, ok, g))
    if kind == "none":
        assert torch.equal(out, b.expand(B, N, cout))
        assert not dw.any()
    grads = []
    for fn in (conv.subm_conv, conv.subm_conv_plain):
        xr = x.clone().requires_grad_()
        fn(xr, idx, ok, w, b).backward(g)
        grads.append(xr.grad)
    _check(*grads)


@pytest.mark.parametrize("cin", [263, 260])
@pytest.mark.parametrize("kind", ["cloud", "none", "duplicates"])
def test_k2_k7_wide_stem(dev, cin, kind):
    """The Concat variant's stem: 125 taps, cin = 7 + 256 input channels
    (263, which the wrappers pad to 264; 260 needs no pad) and 64 outputs.
    K2 forward, the mirrored K2 (the dx launch, cin outputs) and K7 on a
    k = 5 map of a cloud, of no live link and of many duplicate voxels:
    within the bar of the plain versions, bit-equal across two launches,
    one count per wrapper call; then the autograd dx (K8 onto owners,
    mirrored K2) against the plain version's autograd."""
    B, N, cout = 2, 600, 64
    rng = np.random.RandomState(cin + len(kind))
    if kind == "none":
        idx = torch.from_numpy(rng.randint(0, N, (B, N, 125)).astype(
            np.int32)).to(dev)
        ok = torch.zeros(B, N, 125, dtype=torch.bool, device=dev)
    else:
        gc = rng.randint(0, 12 if kind == "cloud" else 4, (B, N, 3))
        mask = np.arange(N)[None] < np.array([[N], [N - 77]])
        nm = build_neighbor_map(torch.from_numpy(gc.astype(np.int32)).to(dev),
                                torch.from_numpy(mask).to(dev), 5, 6,
                                extent=128)
        idx, ok = nm.idx, nm.ok
    x = _randn(rng, dev, B, N, cin)
    w = _randn(rng, dev, 125, cin, cout, scale=(125 * cin) ** -0.5)
    g = _randn(rng, dev, B, N, cout)
    out = _twice(lambda: conv.subm_conv(x, idx, ok, w), "subm_conv")
    _check(out, conv.subm_conv_plain(x, idx, ok, w))
    wm = conv.mirror_weight(w)
    dx = _twice(lambda: conv.subm_conv(g, idx, ok, wm), "subm_conv")
    assert dx.shape == (B, N, cin)
    _check(dx, conv.subm_conv_plain(g, idx, ok, wm))
    dw = _twice(lambda: conv.conv_weight_grad(x, idx, ok, g),
                "conv_weight_grad")
    assert dw.shape == (125, cin, cout)
    _check(dw, conv.conv_weight_grad_plain(x, idx, ok, g))
    if kind == "none":
        assert not out.any() and not dw.any()
    grads = []
    for fn in (conv.subm_conv, conv.subm_conv_plain):
        xr = x.clone().requires_grad_()
        wr = w.clone().requires_grad_()
        fn(xr, idx, ok, wr).backward(g)
        grads.append((xr.grad, wr.grad))
    for got, want in zip(*grads):
        _check(got, want)


def test_k2_k7_wide_stem_long_sums(dev):
    """The wide stem at B = 8 clouds of 4096 points: K7's sums over 32768
    rows and K2's over 125 taps within 1e-4 of the plain version's largest
    value."""
    B, N, C = 8, 4096, 263
    rng = np.random.RandomState(7)
    gc = rng.randint(0, 40, (B, N, 3)).astype(np.int32)
    nm = build_neighbor_map(torch.from_numpy(gc).to(dev),
                            torch.ones(B, N, dtype=torch.bool, device=dev),
                            5, 6, extent=128)
    x = _randn(rng, dev, B, N, C)
    w = _randn(rng, dev, 125, C, 64, scale=(125 * C) ** -0.5)
    g = _randn(rng, dev, B, N, 64)
    for got, want in ((conv.conv_weight_grad(x, nm.idx, nm.ok, g),
                       conv.conv_weight_grad_plain(x, nm.idx, nm.ok, g)),
                      (conv.subm_conv(x, nm.idx, nm.ok, w),
                       conv.subm_conv_plain(x, nm.idx, nm.ok, w))):
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= \
            TOL * float(want.abs().max())


@pytest.mark.parametrize("D", [7, 64, 768])
def test_k8_scatter_rows_add_colliding(dev, D):
    """K8 with many indices colliding on few rows (the duplicate padding of
    the patch maps) and sentinel rows, whose cotangents it drops: bit-equal
    across launches, within the bar of the plain version."""
    rng = np.random.RandomState(9)
    g = torch.from_numpy(rng.randn(2, 1024, D).astype(np.float32)).to(dev)
    idx = rng.randint(0, 40, (2, 1024))
    idx[rng.rand(2, 1024) < 0.2] = 257
    idx[:, :2] = -1
    idx = torch.from_numpy(idx).to(dev)
    _check(_twice(lambda: gather.scatter_rows_add(g, idx, 257),
                  "scatter_rows_add"),
           gather.scatter_rows_add_plain(g, idx, 257))
    x = torch.from_numpy(rng.randn(2, 257, D).astype(np.float32)).to(dev)
    x.requires_grad_()
    gather.gather_rows(x, idx).backward(g)
    _check(x.grad, gather.scatter_rows_add_plain(g, idx, 257))


def _k8_index(rng, kind, B, M, n):
    """(B, M) K8 indices of a kind: `runs` (an unpool's clusters: a cumsum
    of run heads, the tail at the sentinel n), `owner` (a conv's owner
    sums: most rows their own, some an earlier row, some invalid at n),
    `unsorted` (any order, a fifth at n, a few negative or past n),
    `heavy` (every row onto one of three), `sentinel` (no row lands)."""
    if kind == "runs":
        heads = rng.rand(B, M) < 0.4
        heads[:, 0] = True
        idx = np.cumsum(heads, 1) - 1
        idx[:, M - M // 5:] = n
        return np.minimum(idx, n)
    if kind == "owner":
        idx = np.tile(np.arange(M), (B, 1))
        back = rng.rand(B, M) < 0.15
        idx[back] = np.maximum(idx[back] - rng.randint(1, 4, back.sum()), 0)
        idx[rng.rand(B, M) < 0.1] = n
        return idx
    if kind == "unsorted":
        idx = rng.randint(0, n, (B, M))
        idx[rng.rand(B, M) < 0.2] = n
        idx[:, :3] = [-1, n + 9, -5]
        return idx
    if kind == "heavy":
        return rng.randint(0, 3, (B, M))
    return np.where(rng.rand(B, M) < 0.5, n + rng.randint(0, 9, (B, M)), -1)


K8_SHAPES = {"runs": (3000, 1900), "owner": (2100, 2100),
             "unsorted": (1500, 700), "heavy": (2600, 50),
             "sentinel": (500, 300)}


@pytest.mark.parametrize("kind", list(K8_SHAPES))
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("D", [64, 96, 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8_destination_tiles(dev, dtype, D, idx_dtype, kind):
    """K8 at fp32 and bf16 on n != M (but the owner sums' n = M), int32 and
    int64 indices, runs, owner maps, unsorted indices with sentinels,
    heavy collisions (rounds of one source a row) and rows that all drop,
    over more than one 2048-entry chunk: the fp32 sums (and at bf16 the
    rounded sums) bit-equal across launches and to the kernel's order in
    PyTorch (gather.scatter_rows_add_ordered), within the bar of the plain
    version."""
    rng = np.random.RandomState(D + len(kind) + (dtype == BF16))
    B, (M, n) = 3, K8_SHAPES[kind]
    idx = torch.from_numpy(_k8_index(rng, kind, B, M, n)).to(idx_dtype)
    idx = idx.to(dev)
    g = _randn(rng, dev, B, M, D).to(dtype)
    counter = "scatter_rows_add_bf16" if dtype == BF16 else \
        "scatter_rows_add"
    order = gather.scatter_rows_add_ordered(g, idx, n)
    sums = _twice(lambda: gather.scatter_rows_add(g, idx, n, torch.float32),
                  counter)
    assert sums.dtype == torch.float32 and sums.shape == (B, n, D)
    assert torch.equal(sums, order)
    _check(sums, gather.scatter_rows_add_plain(g, idx, n))
    if kind == "sentinel":
        assert not sums.any()
    if dtype == BF16:
        got = _twice(lambda: gather.scatter_rows_add(g, idx, n), counter)
        assert got.dtype == BF16
        assert torch.equal(got, order.to(BF16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8_wide_rows(dev, dtype):
    """K8 on rows wider than a pass's 8192 sums (D = 8200): a tile's
    columns in several passes over the same lists; the fp32 sums equal to
    the kernel's order in PyTorch."""
    rng = np.random.RandomState(81)
    D = 8200
    idx = torch.from_numpy(_k8_index(rng, "unsorted", 2, 64, 40)).to(dev)
    g = _randn(rng, dev, 2, 64, D).to(dtype)
    got = gather.scatter_rows_add(g, idx, 40, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, gather.scatter_rows_add_ordered(g, idx, 40))


def _smallc(rng, B, N, M, C, dev):
    """x (B, N, C) and idx (B, M) with a fifth of the rows at the sentinel
    N and a few negative."""
    x = torch.from_numpy(rng.randn(B, N, C).astype(np.float32)).to(dev)
    idx = rng.randint(0, N, (B, M)).astype(np.int32)
    idx[rng.rand(B, M) < 0.2] = N
    idx[:, :5] = -1
    return x, torch.from_numpy(idx).to(dev)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("C", [4, 5, 7, 20, 32])
def test_k9_gather_rows_smallc(dev, C, dtype):
    """Bit-equal with int32 and int64 indices on ragged row tiles: M not a
    multiple of the 1024-row tile, with M * C a multiple of 4 (float4
    stores) and, for odd C, not (4-byte stores). C = 4, 5 take the
    compile-time width; C = 7 (the policy's stage-0 entry sort) takes the
    runtime width with float4 groups that cross a row boundary."""
    rng = np.random.RandomState(10)
    for M in (1000 * 125 + 4, 1000 * 125 + 5):
        x, idx = _smallc(rng, 3, 1024, M, C, dev)
        idx = idx.to(dtype)
        got = gather.gather_rows_smallc(x, idx)
        assert torch.equal(got, gather.gather_rows_smallc_plain(x, idx))
        assert not got[(idx < 0) | (idx >= 1024)].any()


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [1, 300, 4096])
@pytest.mark.parametrize("C", [1, 4, 5, 7, 8, 20, 32])
def test_k10_scatter_rows_smallc_add(dev, C, n, dtype):
    """K10 under the wrapper's plan (scatter_smallc_plan: one slab or
    several, 1-62 ranges) within the bar of the plain version, one launch
    count per call: indices with a fifth at the sentinel n and a few
    negative or past n, on a ragged last tile; M = 0 (dx all zero); every
    row sent to one destination (the most contention)."""
    rng = np.random.RandomState(C * n)
    B, M = 2, 9 * gather.SMALLC_TILE_ROWS + 3
    idx = rng.randint(0, n, (B, M))
    idx[rng.rand(B, M) < 0.2] = n
    idx[:, :3] = [-1, n + 9, -5]
    g = _randn(rng, dev, B, M, C)
    for i in (idx, np.full((B, M), n - 1), idx[:, :0]):
        it = torch.from_numpy(i).to(dtype).to(dev)
        gi = g[:, :i.shape[1]].contiguous()
        before = cuda_lib.LAUNCHES["scatter_rows_smallc_add"]
        got = gather.scatter_rows_smallc_add(gi, it, n)
        assert cuda_lib.LAUNCHES["scatter_rows_smallc_add"] == before + 1
        _check(got, gather.scatter_rows_smallc_add_plain(gi, it, n))
    assert not got.any()


@pytest.mark.parametrize("C", [5, 20])
@pytest.mark.parametrize("ranges,window", [(1, 300), (3, 300), (3, 100),
                                           (7, 64), (2, 7), (1, 1)])
def test_k10_forced_plans(dev, ranges, window, C):
    """K10 with each plan forced (the plans test_torch_port_stem_vjp.py
    emulates): one slab and many, one range and several, within the bar
    of the plain version, with a hot destination row."""
    rng = np.random.RandomState(ranges * 7 + window + C)
    B, n = 2, 300
    M = 7 * gather.SMALLC_TILE_ROWS + 5
    idx = rng.randint(0, n, (B, M))
    idx[rng.rand(B, M) < 0.2] = n
    idx[:, :3] = [-1, n + 3, -7]
    idx[1, 100:400] = 17
    idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
    g = _randn(rng, dev, B, M, C)
    _check(gather.scatter_rows_smallc_add_split(g, idx, n, ranges, window),
           gather.scatter_rows_smallc_add_plain(g, idx, n))


def test_stem_conv_input_grad(dev):
    """stem_conv with its input requiring a gradient on a release-like map
    of 2 x 4096 points: dx (one matmul, then K10) and dW (K7) within the
    bar of the CPU run through autograd of stem_conv_plain; one K3, one K7
    and one K10 launch."""
    rng = np.random.RandomState(21)
    idx, ok = _stem_map(rng, dev, "release", 2, 4096)
    x = _randn(rng, dev, 2, 4096, 7).requires_grad_()
    w = _randn(rng, dev, 125, 7, 64, scale=0.1).requires_grad_()
    g = _randn(rng, dev, 2, 4096, 64)
    before = dict(cuda_lib.LAUNCHES)
    stem.stem_conv(x, idx, ok, w).backward(g)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in cuda_lib.LAUNCHES.items()
                if v != before[k]}
    assert launched == {"stem_conv": 1, "conv_weight_grad": 1,
                        "scatter_rows_smallc_add": 1}
    xc = x.detach().cpu().requires_grad_()
    wc = w.detach().cpu().requires_grad_()
    stem.stem_conv_plain(xc, idx.cpu(), ok.cpu(), wc).backward(g.cpu())
    _check(x.grad.cpu(), xc.grad)
    _check(w.grad.cpu(), wc.grad)


def test_k9_backward_launches_k10(dev):
    rng = np.random.RandomState(12)
    x, idx = _smallc(rng, 2, 512, 512 * 27, 5, dev)
    g = torch.from_numpy(rng.randn(2, 512 * 27, 5).astype(np.float32))
    x.requires_grad_()
    before = cuda_lib.LAUNCHES["scatter_rows_smallc_add"]
    gather.gather_rows_smallc(x, idx).backward(g.to(dev))
    assert cuda_lib.LAUNCHES["scatter_rows_smallc_add"] == before + 1
    _check(x.grad, gather.scatter_rows_smallc_add_plain(g.to(dev), idx, 512))


def test_grid_coord_matches_host_presort(dev):
    """The device grid must floor like the host presort's float32 numpy
    math, or the presorted frame is not the device's sorted frame."""
    rng = np.random.RandomState(4)
    xyz = rng.uniform(-1.0, 1.0, (1, 1 << 20, 3)).astype(np.float32)
    got = compute_grid_coord(torch.from_numpy(xyz).to(dev),
                             torch.ones(1, 1 << 20, dtype=torch.bool,
                                        device=dev), 0.01, 10)
    want = np.floor((xyz - xyz.min(1, keepdims=True)) / np.float32(0.01))
    want = np.clip(want.astype(np.int32), 0, 1023)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def _raw_cloud(rng, n=200_000):
    """A 20 cm cube of points in the workspace (~8,000 occupied voxels),
    a quarter of them on voxel edges, a tenth far outside the crop."""
    xyz = rng.uniform([0.1, -0.1, 0.8], [0.3, 0.1, 1.0], (n, 3))
    xyz[: n // 4] = np.round(xyz[: n // 4], 2)
    xyz[-n // 10:] += 5.0
    return xyz.astype(np.float32), \
        rng.uniform(0, 255, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("capacity", [16384, 2048])
def test_voxelize_fixed_card_vs_cpu_deterministic(dev, capacity):
    rng = np.random.RandomState(3)
    xyz, _ = _raw_cloud(rng)
    mask = torch.from_numpy(rng.rand(len(xyz)) > 0.2)
    x = torch.from_numpy(xyz)
    want = voxelize_fixed(x, mask, 0.01, capacity)
    got = voxelize_fixed(x.to(dev), mask.to(dev), 0.01, capacity)
    again = voxelize_fixed(x.to(dev), mask.to(dev), 0.01, capacity)
    for g, a in zip(got, again):           # sorted segments: no atomics
        assert torch.equal(g, a)
    _check(got[0].cpu(), want[0])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.cpu(), w)
    assert (int(got[3]) > 0) == (capacity == 2048)


def test_device_preprocess_card_vs_cpu(dev):
    rng = np.random.RandomState(5)
    xyz, rgb = _raw_cloud(rng)
    valid = np.arange(len(xyz)) < len(xyz) - 1000
    rot = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    obb = (np.concatenate([rot, rot], 1),
           rng.uniform(-0.2, 0.2, 6).astype(np.float32),
           np.full(6, 0.1, np.float32))
    ee = np.asarray([0.3, 0, 1.0, 0, 0, 0, 1, 1], np.float32)
    draws = torch.rand(16384, generator=torch.Generator().manual_seed(2))
    kw = dict(workspace=get_robot_workspace(), num_points=4096,
              vox_capacity=16384, xyz_norm=True)
    args = [torch.from_numpy(a) for a in (xyz, rgb, valid, *obb, ee)]
    want = device_preprocess(*args, draws, **kw)
    got = device_preprocess(*[a.to(dev) for a in args], draws.to(dev), **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype in (torch.bool, torch.int64):    # mask, count, overflow
            assert torch.equal(g.cpu(), w), i
        else:
            _check(g.cpu(), w)


def test_prefetch_to_device_onto_the_card(dev):
    """Batches arrive on the card equal to the host's, while the consumer
    runs work on its stream (the copies on the side stream, the event wait
    and record_stream keep them apart); close() stops the producer."""
    rng = np.random.RandomState(6)
    host = [{"x": rng.randn(32, 4096, 7).astype(np.float32),
             "m": rng.rand(32, 4096) > 0.5,
             "n": rng.randint(0, 4096, 32).astype(np.int32)}
            for _ in range(6)]
    pre = PrefetchToDevice(iter(host), dev, depth=2)
    w = torch.randn(2048, 2048, device=dev)
    for i, batch in enumerate(pre):
        assert all(v.device.type == "cuda" for v in batch.values())
        for _ in range(5):                 # keep the stream busy
            w = torch.tanh(w @ w) * 0.5
        total = batch["x"].double().sum() + batch["m"].sum() + \
            batch["n"].sum()
        want = host[i]["x"].astype(np.float64).sum() + host[i]["m"].sum() \
            + host[i]["n"].sum()
        assert abs(float(total) - want) <= 1e-6 * abs(want) + 1e-3
        for k in host[i]:
            assert np.array_equal(batch[k].cpu().numpy(), host[i][k])
    assert i == 5
    pre.close()
    assert not pre.thread.is_alive()


# ---------------------------------------------------------------- bf16 -----
# The bf16 paths (compute_dtype bfloat16, serving and training): K1, K2
# (forward and input gradient), K3, K5, K6 and K8's rounded sums within the
# bar of ops/bf16.py (one bf16 ulp of the value, plus 1e-4 of the call's
# scale for fp32 sums in another order; K1 and K5 plus one bf16 ulp of each
# probability's share, 2^-7 sum_j p_j |v_j|) of their plain versions on the
# same bf16 inputs, and K7's fp32 sums within 1e-4 of the plain version's
# largest value; all but K10 (atomics) bit-equal across two launches; K4
# and K9 copy and are bit-equal; K10's rounded sums within the bar of the
# plain sums rounded once.

BF16 = torch.bfloat16


def _bf16_check(got, want, extra=None, relative=False):
    """Within the bar of ops/bf16.py; `relative` for gradients (the slack
    of max|want| itself)."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == BF16
    assert bf16_excess(got, want, extra=extra, relative=relative) <= 0.0


@pytest.mark.parametrize("Dh", [8, 16, 24, 32])
@pytest.mark.parametrize("P", [128, 37])
@pytest.mark.parametrize("G,H", [(32, 2), (2, 32)])
def test_bf16_k1_patch_attention(dev, G, H, P, Dh):
    g = torch.Generator().manual_seed(G + P + Dh + 1)
    q, k, v = (torch.randn(G, H, P, Dh, generator=g).to(dev).to(BF16)
               for _ in range(3))
    kv = (torch.rand(G, P, generator=g) > 0.2).to(dev)
    kv[0] = False
    args = (q, k, v, kv, Dh ** -0.5)
    got = _twice(lambda: attention.patch_attention(*args),
                 "patch_attention_bf16")
    _bf16_check(got, attention.patch_attention_plain(*args),
                attention.bf16_probability_allowance(*args))
    groups = -(-P // 16)
    for warps in (1, 8):
        assert torch.equal(attention.patch_attention_split(
            *args, warps, -(-groups // warps)), got)


@pytest.mark.parametrize("B,C", [(1, 64), (2, 256), (1, 768), (2, 768)])
def test_bf16_k2_subm_conv(dev, B, C):
    """The CPE widths; B = 1 splits the taps into ranges whose fp32
    partials are summed before the one rounding."""
    rng = np.random.RandomState(C + B)
    gc, mask = _cloud(rng, B=B)
    nm = build_neighbor_map(gc.to(dev), mask[:B].to(dev), 3, 5,
                            extent=128)
    x = _randn(rng, dev, B, 512, C).to(BF16)
    w = _randn(rng, dev, 27, C, C, scale=C ** -0.5).to(BF16)
    b = _randn(rng, dev, C)
    args = (x, nm.idx, nm.ok, w, b)
    got = _twice(lambda: conv.subm_conv(*args), "subm_conv_bf16")
    _bf16_check(got, conv.subm_conv_plain(*args))
    g = _randn(rng, dev, B, 512, C).to(BF16)
    _bf16_conv_backward(x, nm.idx, nm.ok, w, b, g)


def _bf16_dx_plain(g, idx, ok, w):
    """The conv's input gradient at bf16 in plain PyTorch: the fp32 owner
    sums (K8's plain version), the mirrored conv in fp32, one rounding."""
    N, centre = g.shape[1], idx.shape[-1] // 2
    owner, valid = idx[..., centre], ok[..., centre]
    gsum = gather.scatter_rows_add_plain(
        torch.where(valid[..., None], g, torch.zeros_like(g)), owner, N)
    dx = conv.subm_conv_plain(gsum, idx, ok, conv.mirror_weight(w)).to(BF16)
    own = valid & (owner.long() == torch.arange(N, device=g.device)[None])
    return torch.where(own[..., None], dx, torch.zeros_like(dx)), gsum


def _bf16_conv_backward(x, idx, ok, w, b, g):
    """The bf16 conv's backward on the card: the mirrored K2 on the fp32
    owner sums (bit-equal across launches) and the autograd dx within the
    bf16 bar of the plain composition; K7's fp32 sums within 1e-4 of the
    plain version's largest value, bit-equal across launches, and the
    autograd dW its bf16 rounding; db the fp32 sum of g."""
    want_dx, gsum = _bf16_dx_plain(g, idx, ok, w)
    wm = conv.mirror_weight(w)
    mirrored = _twice(lambda: conv._conv_forward(gsum, idx, ok, wm, None),
                      "subm_conv_dx_bf16")
    _bf16_check(mirrored, conv.subm_conv_plain(gsum, idx, ok, wm).to(BF16),
                relative=True)
    dw = _twice(lambda: conv.conv_weight_grad(x, idx, ok, g),
                "conv_weight_grad_bf16")
    assert dw.dtype == torch.float32
    _check_rel(dw, conv.conv_weight_grad_plain(x, idx, ok, g))
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    br = None if b is None else b.clone().requires_grad_()
    cuda_lib.reset_launches()
    conv.subm_conv(xr, idx, ok, wr, br).backward(g)
    torch.cuda.synchronize()
    assert {k: v for k, v in cuda_lib.LAUNCHES.items() if v} == {
        "subm_conv_bf16": 1, "scatter_rows_add_bf16": 1,
        "subm_conv_dx_bf16": 1, "conv_weight_grad_bf16": 1}
    _bf16_check(xr.grad, want_dx, relative=True)
    assert torch.equal(wr.grad, dw.to(BF16))
    if b is not None:
        assert br.grad.dtype == torch.float32
        _check(br.grad, g.float().sum((0, 1)))


@pytest.mark.parametrize("B", [1, 8])
def test_bf16_k2_wide_stem(dev, B):
    """The Concat stem: 125 taps, 263 bf16 channels padded to 264."""
    rng = np.random.RandomState(263 + B)
    N = 1024
    gc = rng.randint(0, 16, (B, N, 3)).astype(np.int32)
    mask = np.ones((B, N), bool)
    nm = build_neighbor_map(torch.from_numpy(gc).to(dev),
                            torch.from_numpy(mask).to(dev), 5, 6, extent=128)
    x = _randn(rng, dev, B, N, 263).to(BF16)
    w = _randn(rng, dev, 125, 263, 64, scale=(125 * 263) ** -0.5).to(BF16)
    args = (x, nm.idx, nm.ok, w)
    got = _twice(lambda: conv.subm_conv(*args), "subm_conv_bf16")
    _bf16_check(got, conv.subm_conv_plain(*args))
    _bf16_conv_backward(x, nm.idx, nm.ok, w, None,
                        _randn(rng, dev, B, N, 64).to(BF16))


@pytest.mark.parametrize("K,cin,cout", [(27, 8, 64), (27, 64, 64),
                                        (27, 263, 128), (125, 8, 64),
                                        (125, 64, 64), (125, 263, 64)])
def test_bf16_k2_tensor_core_shapes(dev, K, cin, cout):
    """K2's bf16 kernel at both tap counts over input widths of one
    16-channel step, one stage and several (263 padded to 264, its last
    stage ragged), on a dense map whose centre tap lists every row (two
    64-row chunks a tap): forward, mirrored dx and the backward within
    their bars, bit-equal across launches."""
    rng = np.random.RandomState(K + cin + cout)
    B, N = 2, 512
    gc = rng.randint(0, 10, (B, N, 3)).astype(np.int32)
    nm = build_neighbor_map(torch.from_numpy(gc).to(dev),
                            torch.ones(B, N, dtype=torch.bool, device=dev),
                            round(K ** (1 / 3)), 6, extent=128)
    x = _randn(rng, dev, B, N, cin).to(BF16)
    w = _randn(rng, dev, K, cin, cout, scale=(K * cin) ** -0.5).to(BF16)
    b = _randn(rng, dev, cout)
    args = (x, nm.idx, nm.ok, w, b)
    got = _twice(lambda: conv.subm_conv(*args), "subm_conv_bf16")
    _bf16_check(got, conv.subm_conv_plain(*args))
    _bf16_conv_backward(x, nm.idx, nm.ok, w, b,
                        _randn(rng, dev, B, N, cout).to(BF16))


@pytest.mark.parametrize("kind", ["cloud", "duplicates"])
def test_bf16_k2_k7_edge_maps(dev, kind):
    """A CPE conv at bf16 on a map with many duplicate voxels (the owner
    sums add several cotangents) and on a cloud's."""
    rng = np.random.RandomState(17 + len(kind))
    nm = _conv_map(rng, dev, 2, 300, 4 if kind == "duplicates" else 12)
    x = _randn(rng, dev, 2, 300, 128).to(BF16)
    w = _randn(rng, dev, 27, 128, 128, scale=128 ** -0.5).to(BF16)
    _bf16_conv_backward(x, nm.idx, nm.ok, w, _randn(rng, dev, 128),
                        _randn(rng, dev, 2, 300, 128).to(BF16))


@pytest.mark.parametrize("Dh", [8, 16, 24, 32])
@pytest.mark.parametrize("P", [128, 77, 37])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_bf16_k5_k6_attention_dropout(dev, rate, P, Dh):
    """K5 at bf16: the bits bit-equal to the fp32 path's (philox_keep_mask),
    out within the bf16 bar plus the dropped probabilities' allowance, lse
    within 1e-4; K6 on K5's outputs within the bf16 bar of its plain
    version; both bit-equal across two launches; the autograd path one K5
    and one K6 launch. Patch 0 has no valid key (p = 1 / P, ds = 0);
    P = 77 and 37 end inside a 16-key block."""
    G, H, seed, scale = 6, 3, 987654321, Dh ** -0.5
    q, k, v, kv, gout = (t.to(BF16) if t.is_floating_point() else t
                         for t in _attn_dropout_inputs(dev, G, H, P, Dh))
    run5 = lambda: attention.patch_attention_dropout_fwd(  # noqa: E731
        q, k, v, kv, scale, rate, seed)
    before = cuda_lib.LAUNCHES["patch_attention_dropout_bf16"]
    (out, lse, bits), again = run5(), run5()
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["patch_attention_dropout_bf16"] == before + 2
    for a, b in zip((out, lse, bits), again):
        assert torch.equal(a, b)
    p_out, p_lse, p_bits = attention.patch_attention_dropout_fwd_plain(
        q, k, v, kv, scale, rate, seed)
    assert torch.equal(bits, p_bits)
    keep = attention.philox_keep_mask(seed, G, H, P, rate, dev)
    assert torch.equal(bits, attention.pack_keep_bits(keep))
    assert lse.dtype == torch.float32
    _check(lse[1:], p_lse[1:])
    _bf16_check(out, p_out, attention.bf16_probability_allowance(
        q, k, v, kv, scale, rate, keep))
    got = _twice(lambda: torch.stack(attention.patch_attention_dropout_bwd(
        q, k, v, kv, out, lse, bits, gout, scale, rate)),
        "patch_attention_dropout_bwd_bf16")
    want = attention.patch_attention_dropout_bwd_plain(
        q, k, v, kv, out, lse, bits, gout, scale, rate)
    for a, b in zip(got, want):
        _bf16_check(a, b.to(BF16), relative=True)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    cuda_lib.reset_launches()
    attention.patch_attention_dropout(qr, kr, vr, kv, scale, rate,
                                      seed).backward(gout)
    torch.cuda.synchronize()
    assert {k: v for k, v in cuda_lib.LAUNCHES.items() if v} == {
        "patch_attention_dropout_bf16": 1,
        "patch_attention_dropout_bwd_bf16": 1}
    for a, b in zip((qr.grad, kr.grad, vr.grad), got):
        assert torch.equal(a, b)


def test_bf16_k5_rate0_matches_k1(dev):
    """K5 at bf16 and rate 0 rounds where K1's bf16 path does: equal."""
    g = torch.Generator().manual_seed(16)
    q, k, v = (torch.randn(8, 4, 128, 32, generator=g).to(dev).to(BF16)
               for _ in range(3))
    kv = (torch.rand(8, 128, generator=g) > 0.3).to(dev)
    assert torch.equal(
        attention.patch_attention_dropout_fwd(q, k, v, kv, 0.2, 0.0, 7)[0],
        attention.patch_attention(q, k, v, kv, 0.2))


@pytest.mark.parametrize("K,cin,cout", [(27, 64, 64), (27, 256, 128),
                                        (27, 768, 768), (125, 7, 64),
                                        (125, 263, 64)])
def test_bf16_k7_conv_weight_grad(dev, K, cin, cout):
    """K7 at bf16 (bf16 mma.sync with fp32 sums): the CPE path, the
    policy stem's (tap, channel) path and the Concat stem's 263 channels
    (padded to 264); clouds of 509 and 4093 rows, so that the live lists
    of most taps end inside a 16-row step."""
    rng = np.random.RandomState(K + cin + cout)
    B, N = (8, 4093) if cin == 7 else (2, 509)
    gc = rng.randint(0, 24 if N == 509 else 40, (B, N, 3)).astype(np.int32)
    nm = build_neighbor_map(torch.from_numpy(gc).to(dev),
                            torch.ones(B, N, dtype=torch.bool, device=dev),
                            round(K ** (1 / 3)), 6, extent=128)
    counts = nm.ok.sum((0, 1))
    assert bool((counts % 16 != 0).any())
    x = _randn(rng, dev, B, N, cin).to(BF16)
    g = _randn(rng, dev, B, N, cout).to(BF16)
    args = (x, nm.idx, nm.ok, g)
    got = _twice(lambda: conv.conv_weight_grad(*args),
                 "conv_weight_grad_bf16")
    assert got.dtype == torch.float32 and got.shape == (K, cin, cout)
    _check_rel(got, conv.conv_weight_grad_plain(*args))


@pytest.mark.parametrize("kind", ["none", "one", "duplicates"])
@pytest.mark.parametrize("K,cin,cout", [(27, 64, 128), (125, 7, 64)])
def test_bf16_k7_edge_maps(dev, kind, K, cin, cout):
    """K7 at bf16 on a map with no live link (dW zero), with one live link
    (a list of one row, 15 rows of zero fill) and with many duplicate
    voxels: the CPE path and the stem's, bit-equal across launches, within
    the bar of the plain version (exact where it is a single product)."""
    B, N = 2, 300
    rng = np.random.RandomState(31 + K)
    if kind == "duplicates":
        gc = rng.randint(0, 4, (B, N, 3)).astype(np.int32)
        nm = build_neighbor_map(torch.from_numpy(gc).to(dev),
                                torch.ones(B, N, dtype=torch.bool,
                                           device=dev),
                                round(K ** (1 / 3)), 5, extent=128)
        idx, ok = nm.idx, nm.ok
    else:
        idx = torch.from_numpy(rng.randint(0, N, (B, N, K)).astype(
            np.int32)).to(dev)
        ok = torch.zeros(B, N, K, dtype=torch.bool, device=dev)
        if kind == "one":
            ok[1, 200, K // 2] = True
            idx[1, 200, K // 2] = 17
    x = _randn(rng, dev, B, N, cin).to(BF16)
    g = _randn(rng, dev, B, N, cout).to(BF16)
    args = (x, idx, ok, g)
    got = _twice(lambda: conv.conv_weight_grad(*args),
                 "conv_weight_grad_bf16")
    want = conv.conv_weight_grad_plain(*args)
    if kind == "duplicates":
        _check_rel(got, want)
    else:
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert bool(got.any()) == (kind == "one")


def test_bf16_stem_weight_grad_and_input_grad(dev):
    """The policy stem at bf16 with x and W requiring gradients: one K3,
    one K7 and one K10 bf16 launch; dW is K7's fp32 sums rounded once; dx
    (G = g W^T in bf16, then K10's bf16 path) within the bar of the plain
    composition (the same G, K10's plain version: fp32 sums, one
    rounding)."""
    rng = np.random.RandomState(21)
    idx, ok = _stem_map(rng, dev, "release", 4, 4096)
    x = _randn(rng, dev, 4, 4096, 7).to(BF16)
    w = _randn(rng, dev, 125, 7, 64, scale=0.1).to(BF16)
    g = _randn(rng, dev, 4, 4096, 64).to(BF16)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    cuda_lib.reset_launches()
    stem.stem_conv(xr, idx, ok, wr).backward(g)
    torch.cuda.synchronize()
    assert {k: v for k, v in cuda_lib.LAUNCHES.items() if v} == {
        "stem_conv_bf16": 1, "conv_weight_grad_bf16": 1,
        "scatter_rows_smallc_add_bf16": 1}
    assert torch.equal(wr.grad, conv.conv_weight_grad(x, idx, ok, g).to(BF16))
    G, flat = stem.stem_grad_rows(g, idx, ok, w, 4096)
    assert G.dtype == BF16
    _bf16_check(xr.grad, gather.scatter_rows_smallc_add_plain(
        G, flat, 4096).to(BF16), relative=True)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [1, 300, 4096])
@pytest.mark.parametrize("C", [1, 4, 5, 7, 8, 9, 20, 32])
def test_bf16_k10_scatter_rows_smallc_add(dev, C, n, dtype):
    """K10 at bf16 under the wrapper's plan within the bf16 bar of the
    plain sums rounded once, one bf16 launch count per call: a fifth of
    the rows at the sentinel n and a few negative or past n, a ragged
    last tile (C <= 8: M C a multiple of 8 and M of 4, 16-byte loads, or
    not, 2-byte ones; C > 8: scatter_smallc_kernel's 8- or 2-byte
    loads); every row dead; every row live; g and idx at an odd element
    offset; M = 0 (dx all zero); every row onto one destination; K9's
    backward at bf16 the same launch. The shared-memory adds come in
    arrival order, so K10 is held to the bar, not bit for bit."""
    rng = np.random.RandomState(C * n + 1)
    B = 2
    for M in (9 * gather.SMALLC_TILE_ROWS + 8,
              9 * gather.SMALLC_TILE_ROWS + 4,
              9 * gather.SMALLC_TILE_ROWS + 3):
        idx = rng.randint(0, n, (B, M))
        idx[rng.rand(B, M) < 0.2] = n
        idx[:, :3] = [-1, n + 9, -5]
        g = _randn(rng, dev, B, M, C).to(BF16)
        live = rng.randint(0, n, (B, M))
        for i, off in ((idx, False), (idx, True), (np.full((B, M), n), False),
                       (live, False), (np.full((B, M), n - 1), False),
                       (idx[:, :0], False)):
            it = torch.from_numpy(i).to(dtype).to(dev)
            gi = g[:, :i.shape[1]].contiguous()
            if off:
                gi, it = _offset(gi), _offset(it)
            before = cuda_lib.LAUNCHES["scatter_rows_smallc_add_bf16"]
            got = gather.scatter_rows_smallc_add(gi, it, n)
            assert cuda_lib.LAUNCHES["scatter_rows_smallc_add_bf16"] == \
                before + 1
            _bf16_check(got, gather.scatter_rows_smallc_add_plain(
                gi, it, n).to(BF16), relative=True)
        assert not got.any()
    x = _randn(rng, dev, B, n, C).to(BF16).requires_grad_()
    it = torch.from_numpy(idx).to(dtype).to(dev)
    before = cuda_lib.LAUNCHES["scatter_rows_smallc_add_bf16"]
    gather.gather_rows_smallc(x, it).backward(g)
    assert cuda_lib.LAUNCHES["scatter_rows_smallc_add_bf16"] == before + 1
    _bf16_check(x.grad, gather.scatter_rows_smallc_add_plain(g, it, n).to(
        BF16), relative=True)


@pytest.mark.parametrize("C", [1, 5, 7, 20])
@pytest.mark.parametrize("ranges,window", [(1, 300), (3, 300), (3, 100),
                                           (7, 64), (2, 7), (1, 1)])
def test_bf16_k10_forced_plans(dev, ranges, window, C):
    """K10 at bf16 with each plan forced: the ranges' fp32 partials summed
    before the one rounding, within the bf16 bar of the plain version,
    with a hot destination row."""
    rng = np.random.RandomState(ranges * 7 + window + C + 1)
    B, n = 2, 300
    M = 7 * gather.SMALLC_TILE_ROWS + 5
    idx = rng.randint(0, n, (B, M))
    idx[rng.rand(B, M) < 0.2] = n
    idx[:, :3] = [-1, n + 3, -7]
    idx[1, 100:400] = 17
    idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
    g = _randn(rng, dev, B, M, C).to(BF16)
    got = gather.scatter_rows_smallc_add_split(g, idx, n, ranges, window)
    assert got.dtype == BF16
    _bf16_check(got, gather.scatter_rows_smallc_add_plain(g, idx, n).to(
        BF16), relative=True)


@pytest.mark.parametrize("D", [7, 64, 768])
def test_bf16_k8_scatter_rows_add(dev, D):
    """K8 at bf16 with colliding indices and sentinel rows: the fp32 sums
    within 1e-4 of the plain version's, the rounded sums within the bf16
    bar of the plain sums rounded once; gather_rows' backward at bf16 one
    K8 launch."""
    rng = np.random.RandomState(90 + D)
    g = _randn(rng, dev, 2, 1024, D).to(BF16)
    idx = rng.randint(0, 40, (2, 1024))
    idx[rng.rand(2, 1024) < 0.2] = 257
    idx[:, :2] = -1
    idx = torch.from_numpy(idx).to(dev)
    want = gather.scatter_rows_add_plain(g, idx, 257)
    sums = gather.scatter_rows_add(g, idx, 257, torch.float32)
    assert sums.dtype == torch.float32
    _check(sums, want)
    got = gather.scatter_rows_add(g, idx, 257)
    _bf16_check(got, want.to(BF16), relative=True)
    x = _randn(rng, dev, 2, 257, D).to(BF16).requires_grad_()
    cuda_lib.reset_launches()
    gather.gather_rows(x, idx).backward(g)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["scatter_rows_add_bf16"] == 1
    assert x.grad.dtype == BF16
    _bf16_check(x.grad, want.to(BF16), relative=True)


@pytest.mark.parametrize("cout", [64, 96])
@pytest.mark.parametrize("kind", ["none", "release", "all"])
@pytest.mark.parametrize("B,cin", [(1, 7), (4, 7), (32, 7), (1, 8), (32, 8)])
def test_bf16_k3_stem_conv(dev, B, cin, kind, cout):
    """K3 at bf16 (m16n8k16 on tap pairs, x padded to 8 channels where
    Cin = 7) at the B = 1 (tap ranges), B = 4 and B = 32 plans, Cout 64 and
    96 (two column tiles, the second half empty), on maps with no live
    link, every link live and a release-like one: bit-equal across two
    launches, within the bf16 bar of the plain version."""
    rng = np.random.RandomState(B + cin + len(kind) + cout)
    N = 4096
    idx, ok = _stem_map(rng, dev, kind, B, N)
    x = _randn(rng, dev, B, N, cin).to(BF16)
    w = _randn(rng, dev, 125, cin, cout, scale=0.1).to(BF16)
    got = _twice(lambda: stem.stem_conv(x, idx, ok, w), "stem_conv_bf16")
    _bf16_check(got, stem.stem_conv_plain(x, idx, ok, w))
    if kind == "none":
        assert not got.any()


@pytest.mark.parametrize("cols,warps,splits,blocks", [
    (64, 1, 1, 125), (64, 2, 8, 63), (64, 4, 3, 32), (32, 8, 5, 16),
    (64, 16, 1, 3), (32, 16, 1, 132)])
def test_bf16_k3_stem_conv_plans(dev, cols, warps, splits, blocks):
    """K3 at bf16 with each plan forced: tap ranges of odd lengths (a last
    tap paired with a zero one), 32 and 64 columns a block, few blocks
    whose warps walk many row groups, a 16-row group across two clouds,
    and Cout = 68 (zero weight columns up to 72, dropped)."""
    rng = np.random.RandomState(warps * 17 + splits + cols + 1)
    idx, ok = _stem_map(rng, dev, "release", 2, 1000)
    x = _randn(rng, dev, 2, 1000, 7).to(BF16)
    w = _randn(rng, dev, 125, 7, 68, scale=0.1).to(BF16)
    got = _twice(lambda: stem.stem_conv_split(x, idx, ok, w, cols, warps,
                                              splits, blocks),
                 "stem_conv_bf16")
    assert got.shape == (2, 1000, 68)
    _bf16_check(got, stem.stem_conv_plain(x, idx, ok, w))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("D", [7, 64, 96, 768])
def test_bf16_k4_gather_rows(dev, D, offset):
    """Bit-equal with sentinel rows; offset 1 puts x 2 bytes past an
    aligned start (the 4- and 2-byte word paths)."""
    rng = np.random.RandomState(D + offset)
    flat = _randn(rng, dev, 3 * 257 * D + offset).to(BF16)
    x = flat[offset:].view(3, 257, D)
    for dtype in (torch.int32, torch.int64):
        idx = _sentinel_idx(rng, 3, 1021, 257, dtype).to(dev)
        before = cuda_lib.LAUNCHES["gather_rows_bf16"]
        got = gather.gather_rows(x, idx)
        assert cuda_lib.LAUNCHES["gather_rows_bf16"] == before + 1
        assert got.dtype == BF16
        assert torch.equal(got.view(torch.int16),
                           gather.gather_rows_plain(x, idx).view(torch.int16))


def _offset(t):
    """A contiguous copy of t that starts one element past an aligned
    allocation (2 bytes for bf16, 4 / 8 for int32 / int64 indices)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("C", [1, 4, 5, 7, 8, 9, 20, 24, 32])
def test_bf16_k9_gather_rows_smallc(dev, C, dtype):
    """K9 at bf16 bit-equal to its plain version, one bf16 launch count a
    call: a fifth of the rows at the sentinel and a few negative, on
    ragged tiles with M C a multiple of 8 or not (the clouds after the
    first then start their output off 16 bytes: 2-byte stores), N C not a
    multiple of 4 (the clouds after the first start off x's 8-byte grid),
    every row dead, every row live, and x and idx at an odd element offset
    (x's rows then read from below its start on its 8-byte grid; idx 4-
    or 8-byte index loads)."""
    rng = np.random.RandomState(40 + C)
    for N, M in ((1024, 1000 * 125 + 8), (1024, 1000 * 125 + 5),
                 (1023, 1000 * 125 + 5)):
        x, idx = _smallc(rng, 3, N, M, C, dev)
        x, idx = x.to(BF16), idx.to(dtype)
        for xi, ii in ((x, idx), (x, torch.full_like(idx, N)),
                       (x, idx.clamp(0, N - 1)), (_offset(x), _offset(idx)),
                       (x, _offset(idx))):
            before = cuda_lib.LAUNCHES["gather_rows_smallc_bf16"]
            got = gather.gather_rows_smallc(xi, ii)
            assert cuda_lib.LAUNCHES["gather_rows_smallc_bf16"] == before + 1
            assert torch.equal(
                got.view(torch.int16),
                gather.gather_rows_smallc_plain(xi, ii).view(torch.int16))


# the grounding pipeline's device helpers (not kernels: torch ops)

@pytest.mark.parametrize("masked", [False, True])
def test_farthest_point_sample_card_vs_cpu(dev, masked):
    from robot3dlotus_tpu_torch.ops.sampling import farthest_point_sample
    rng = np.random.RandomState(7)
    xyz = torch.from_numpy(rng.randn(4096, 3).astype(np.float32))
    mask = torch.from_numpy(rng.rand(4096) > 0.3) if masked else None
    want = farthest_point_sample(xyz, 256, mask, start=3)
    got = farthest_point_sample(xyz.to(dev), 256,
                                None if mask is None else mask.to(dev),
                                start=3)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("reduction", ["mean", "sum", "min"])
def test_chamfer_card_vs_cpu(dev, reduction):
    from robot3dlotus_tpu_torch.ops.chamfer import (chamfer_distance,
                                                    chamfer_distance_np)
    rng = np.random.RandomState(8)
    a = rng.randn(3000, 3).astype(np.float32) * 0.1
    b = rng.randn(2000, 3).astype(np.float32) * 0.1 + 0.02
    got = chamfer_distance(torch.from_numpy(a).to(dev),
                           torch.from_numpy(b).to(dev), reduction)
    want = chamfer_distance_np(a, b, reduction)
    assert got.device.type == "cuda"
    assert abs(float(got) - want) <= 1e-4 * max(abs(want), 1e-3)


# ---- K1, K5 and K6 with the attention options (head_scale, rpe) ----
# Every instantiation (fp32 and bf16; the scale alone, the bias alone,
# both) against the plain versions with the same options: fp32 within
# 1e-4 of max(1, |plain|) (gradients and the options' gradients within
# 1e-4 of their own scale), bf16 within the ops/bf16.py bar (K1 and K5
# plus the probabilities' allowance); every kernel bit-equal across two
# launches (K6's options' partials are summed in a fixed order, no
# atomics).

OPTION_SETS = ["both", "rpe", "scale"]


def _opt_inputs(dev, which, G, H, P, Dh, dtype, seed=11):
    """q, k, v, key_valid, g and (scale, head_scale, rpe): under the scale
    q and k unit rows (scaled cosine attention) and scale 1, head scales
    of 5-40; under the bias grid coordinates spanning several times its
    bound (the clip bites) and a table of 0.3-scale rows."""
    q, k, v, kv, g = _attn_dropout_inputs(dev, G, H, P, Dh, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    scale, hs, rpe = Dh ** -0.5, None, None
    if which in ("both", "scale"):
        q = q / q.norm(dim=-1, keepdim=True)
        k = k / k.norm(dim=-1, keepdim=True)
        scale = 1.0
        hs = (torch.rand(H, generator=gen) * 35 + 5).to(dev)
    if which in ("both", "rpe"):
        b = attention.pos_bound(P)
        gc = torch.randint(0, 4 * b, (G, P, 3), generator=gen,
                           dtype=torch.int32).to(dev)
        table = (torch.randn(3 * (2 * b + 1), H, generator=gen) * 0.3).to(dev)
        rpe = (gc, table, b)
    q, k, v, g = (t.to(dtype) for t in (q, k, v, g))
    return q, k, v, kv, g, (scale, hs, rpe)


def _opt_kernel(name, dtype):
    return name + "_opts" + ("_bf16" if dtype == BF16 else "")


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("which", OPTION_SETS)
@pytest.mark.parametrize("Dh", [8, 16, 24, 32])
@pytest.mark.parametrize("P", [128, 37])
def test_k1_attention_options(dev, P, Dh, which, dtype):
    """K1 with the options at B = 1 stage-0 counts (G, H = 32, 2) against
    its plain version, patch 0 with no valid key, bit-equal across two
    launches and across query splits."""
    G, H = 32, 2
    q, k, v, kv, _, (scale, hs, rpe) = _opt_inputs(dev, which, G, H, P, Dh,
                                                   dtype)
    args = (q, k, v, kv, scale)
    run = lambda: attention.patch_attention(  # noqa: E731
        *args, head_scale=hs, rpe=rpe)
    got = _twice(run, _opt_kernel("patch_attention", dtype))
    want = attention.patch_attention_plain(*args, hs, rpe)
    if dtype == BF16:
        _bf16_check(got, want, attention.bf16_probability_allowance(
            *args, head_scale=hs, rpe=rpe))
    else:
        _check(got, want)
    groups = -(-P // 16)
    for warps in (1, 8):
        assert torch.equal(attention.patch_attention_split(
            *args, warps, -(-groups // warps), head_scale=hs, rpe=rpe), got)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("which", OPTION_SETS)
@pytest.mark.parametrize("Dh", [8, 16, 24, 32])
@pytest.mark.parametrize("P,rate", [(128, 0.1), (37, 0.1), (128, 0.0)])
def test_k5_k6_attention_options(dev, P, rate, Dh, which, dtype):
    """K5 and K6 with the options: K5's out, lse and bits, K6's dq, dk, dv
    and the options' gradients (dtable, dhead_scale) against the plain
    versions, each kernel bit-equal across two launches; the autograd path
    one K5 and one K6 launch, its table and scale gradients K6's."""
    G, H, seed = 6, 3, 24681357
    q, k, v, kv, gout, (scale, hs, rpe) = _opt_inputs(dev, which, G, H, P,
                                                      Dh, dtype)
    opts = dict(head_scale=hs, rpe=rpe)
    run5 = lambda: attention.patch_attention_dropout_fwd(  # noqa: E731
        q, k, v, kv, scale, rate, seed, **opts)
    (out, lse, bits), again = run5(), run5()
    torch.cuda.synchronize()
    for a, b in zip((out, lse, bits), again):
        assert torch.equal(a, b)
    p_out, p_lse, p_bits = attention.patch_attention_dropout_fwd_plain(
        q, k, v, kv, scale, rate, seed, **opts)
    assert torch.equal(bits, p_bits)
    _check(lse[1:], p_lse[1:])
    if dtype == BF16:
        keep = attention.philox_keep_mask(seed, G, H, P, rate, dev)
        _bf16_check(out, p_out, attention.bf16_probability_allowance(
            q, k, v, kv, scale, rate, keep, **opts))
    else:
        _check(out, p_out)
    run6 = lambda: attention.patch_attention_dropout_bwd(  # noqa: E731
        q, k, v, kv, out, lse, bits, gout, scale, rate, **opts)
    got, again = run6(), run6()
    want = attention.patch_attention_dropout_bwd_plain(
        q, k, v, kv, out, lse, bits, gout, scale, rate, **opts)
    assert len(got) == len(want) == 5
    for a, b, c in zip(got, again, want):
        assert (a is None) == (c is None)
        if a is None:
            continue
        assert torch.equal(a, b)
        if a.dtype == BF16:
            _bf16_check(a, c.to(BF16), relative=True)
        else:
            _check_rel(a, c)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    hs_r = None if hs is None else hs.clone().requires_grad_()
    tab_r = None if rpe is None else rpe[1].clone().requires_grad_()
    cuda_lib.reset_launches()
    attention.patch_attention_dropout(
        *leaves, kv, scale, rate, seed, hs_r,
        None if rpe is None else (rpe[0], tab_r, rpe[2])).backward(gout)
    torch.cuda.synchronize()
    assert {k: v for k, v in cuda_lib.LAUNCHES.items() if v} == {
        _opt_kernel("patch_attention_dropout", dtype): 1,
        _opt_kernel("patch_attention_dropout_bwd", dtype): 1}
    for a, b in zip(leaves, got[:3]):
        assert torch.equal(a.grad, b)
    if rpe is not None:
        assert torch.equal(tab_r.grad, got[3])
    if hs is not None:
        assert torch.equal(hs_r.grad, got[4])


@pytest.mark.parametrize("which", OPTION_SETS)
@pytest.mark.parametrize("Dh", [8, 32])
@pytest.mark.parametrize("P,rate", [(128, 0.1), (37, 0.0)])
def test_attention_options_mixed_route(dev, P, rate, Dh, which):
    """upcast_attention at bf16 with the options: fp32 q and k, bf16 v
    (K1 and K5's _opts_mixed entry points and the fp32 K6 with the
    options, counted as the fp32 _opts kernels): K1 and K5's out (fp32,
    the probabilities rounded to bf16) and K6's dq, dk (fp32), dv (bf16)
    and the options' gradients against the plain versions within the
    ops/bf16.py bar (K1 / K5 plus the probabilities' allowance; K6 of each
    gradient's own scale), each kernel bit-equal across two launches."""
    G, H, seed = 6, 3, 97531
    q, k, v, kv, gout, (scale, hs, rpe) = _opt_inputs(dev, which, G, H, P,
                                                      Dh, torch.float32)
    v = v.to(BF16)
    opts = dict(head_scale=hs, rpe=rpe)
    got = _twice(lambda: attention.patch_attention(q, k, v, kv, scale,
                                                   **opts),
                 "patch_attention_opts")
    assert got.dtype == torch.float32
    assert bf16_excess(got, attention.patch_attention_plain(
        q, k, v, kv, scale, hs, rpe), extra=attention.
        bf16_probability_allowance(q, k, v, kv, scale, **opts)) <= 0.0
    run5 = lambda: attention.patch_attention_dropout_fwd(  # noqa: E731
        q, k, v, kv, scale, rate, seed, **opts)
    (out, lse, bits), again = run5(), run5()
    torch.cuda.synchronize()
    for a, b in zip((out, lse, bits), again):
        assert torch.equal(a, b)
    p_out, p_lse, p_bits = attention.patch_attention_dropout_fwd_plain(
        q, k, v, kv, scale, rate, seed, **opts)
    assert torch.equal(bits, p_bits)
    _check(lse[1:], p_lse[1:])
    keep = attention.philox_keep_mask(seed, G, H, P, rate, dev)
    assert bf16_excess(out, p_out, extra=attention.bf16_probability_allowance(
        q, k, v, kv, scale, rate, keep, **opts)) <= 0.0
    run6 = lambda: attention.patch_attention_dropout_bwd(  # noqa: E731
        q, k, v, kv, out, lse, bits, gout, scale, rate, **opts)
    got, again = run6(), run6()
    want = attention.patch_attention_dropout_bwd_plain(
        q, k, v, kv, out, lse, bits, gout, scale, rate, **opts)
    torch.cuda.synchronize()
    assert got[2].dtype == BF16
    for a, b, c in zip(got, again, want):
        assert (a is None) == (c is None)
        if a is not None:
            assert torch.equal(a, b)
            assert bf16_excess(a, c.to(a.dtype), relative=True) <= 0.0
    for dtype in (torch.float32, BF16):
        assert attention.bwd_opts_blocks_per_sm(dtype, Dh, hs is not None,
                                                rpe is not None) == 2


def test_k1_options_refuse_a_gradient(dev):
    """K1 has no backward, with the options too: a table or a scale that
    needs a gradient is refused."""
    q, k, v, kv, _, (scale, hs, rpe) = _opt_inputs(dev, "both", 4, 2, 64,
                                                   32, torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        attention.patch_attention(q, k, v, kv, scale,
                                  hs.clone().requires_grad_(), rpe)
    with pytest.raises(RuntimeError, match="no backward"):
        attention.patch_attention(q, k, v, kv, scale, hs, (
            rpe[0], rpe[1].clone().requires_grad_(), rpe[2]))
