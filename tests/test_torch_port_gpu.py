"""The PyTorch port on a CUDA card: each kernel (K1-K10) against its plain
version, the gathers' direct and autograd paths, the launch stream, and the
card's grid coordinates against the host presort's.
Tolerance 1e-4 * max(1, max|plain|): fp32 on both sides, other summation
orders (K8's and K10's atomics in a run-dependent one); the gathers K4 and
K9 only copy and must be bit-equal.

Every case carries the `gpu` marker and skips without a card. The file
imports neither jax nor the JAX package, so it runs on a machine that has
only the port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""
import numpy as np
import pytest
import torch

from robot3dlotus_tpu_torch.models.ptv3 import compute_grid_coord
from robot3dlotus_tpu_torch.ops import attention, conv, cuda_lib, gather, stem
from robot3dlotus_tpu_torch.ops.sparse_conv import build_neighbor_map

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


@pytest.mark.parametrize("G,H,Dh", [(32, 2, 32), (2, 32, 24), (4, 16, 32)])
def test_k1_patch_attention(dev, G, H, Dh):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(G, H, 128, Dh, generator=g).to(dev)
               for _ in range(3))
    kv = (torch.rand(G, 128, generator=g) > 0.2).to(dev)
    kv[0] = False                      # fully masked: uniform weights
    args = (q, k, v, kv, Dh ** -0.5)
    _check(attention.patch_attention(*args),
           attention.patch_attention_plain(*args))


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


def test_k3_stem_conv(dev):
    rng = np.random.RandomState(2)
    gc, mask = _cloud(rng)
    nm = build_neighbor_map(gc.to(dev), mask.to(dev), 5, 5, extent=128)
    x = torch.from_numpy(rng.randn(2, 512, 7).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(125, 7, 64) * 0.1).astype(np.float32))
    args = (x, nm.idx, nm.ok, w.to(dev))
    _check(stem.stem_conv(*args), stem.stem_conv_plain(*args))


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


@pytest.mark.parametrize("D", [7, 64, 768])
def test_k8_scatter_rows_add_colliding(dev, D):
    """K8 with many indices colliding on few rows (the duplicate padding of
    the patch maps) and sentinel rows, whose cotangents it drops; atomics
    sum in a run-dependent order."""
    rng = np.random.RandomState(9)
    g = torch.from_numpy(rng.randn(2, 1024, D).astype(np.float32)).to(dev)
    idx = rng.randint(0, 40, (2, 1024))
    idx[rng.rand(2, 1024) < 0.2] = 257
    idx[:, :2] = -1
    idx = torch.from_numpy(idx).to(dev)
    _check(gather.scatter_rows_add(g, idx, 257),
           gather.scatter_rows_add_plain(g, idx, 257))
    x = torch.from_numpy(rng.randn(2, 257, D).astype(np.float32)).to(dev)
    x.requires_grad_()
    gather.gather_rows(x, idx).backward(g)
    _check(x.grad, gather.scatter_rows_add_plain(g, idx, 257))


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


@pytest.mark.parametrize("C", [5, 20])
def test_k10_scatter_rows_smallc_add(dev, C):
    rng = np.random.RandomState(11)
    _, idx = _smallc(rng, 2, 1024, 1024 * 125, C, dev)
    g = torch.from_numpy(rng.randn(2, 1024 * 125, C).astype(np.float32))
    g = g.to(dev)
    _check(gather.scatter_rows_smallc_add(g, idx, 1024),
           gather.scatter_rows_smallc_add_plain(g, idx, 1024))


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
