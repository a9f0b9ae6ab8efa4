"""The PyTorch port on a CUDA card: each kernel (K1-K8) against its plain
version, and the card's grid coordinates against the host presort's.
Tolerance 1e-4 * max(1, max|plain|): fp32 on both sides, other summation
orders (K8's atomics in a run-dependent one).

Every case carries the `gpu` marker and skips without a card. The file
imports neither jax nor the JAX package, so it runs on a machine that has
only the port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""
import numpy as np
import pytest
import torch

from robot3dlotus_tpu_torch.models.ptv3 import compute_grid_coord
from robot3dlotus_tpu_torch.ops import attention, conv, gather, stem
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


@pytest.mark.parametrize("D", [7, 128, 512])
def test_k4_gather_rows(dev, D):
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 257, D).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.randint(0, 257, (2, 1024))).to(dev)
    assert torch.equal(gather.gather_rows(x, idx),
                       gather.gather_rows_plain(x, idx))


@pytest.mark.parametrize("G,H,Dh,rate", [(16, 2, 32, 0.1), (4, 32, 24, 0.1),
                                         (8, 4, 32, 0.0), (6, 2, 8, 0.5)])
def test_k5_k6_attention_dropout(dev, G, H, Dh, rate):
    """K5 and K6 against the plain versions fed the kernel's own mask
    (written out by attention_dropout_mask), which must equal the PyTorch
    Philox mask bit for bit."""
    g = torch.Generator().manual_seed(5)
    q, k, v, gout = (torch.randn(G, H, 128, Dh, generator=g).to(dev)
                     for _ in range(4))
    kv = (torch.rand(G, 128, generator=g) > 0.2).to(dev)
    kv[0] = False
    seed, scale = 123456789, Dh ** -0.5
    keep = attention.attention_dropout_mask(seed, G, H, 128, rate, dev)
    assert torch.equal(keep.cpu(), attention.philox_keep_mask(
        seed, G, H, 128, rate))
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    out = attention.patch_attention_dropout(qr, kr, vr, kv, scale, rate, seed)
    out.backward(gout)
    _check(out, attention.patch_attention_dropout_plain(
        q, k, v, kv, scale, rate, keep))
    want = attention.patch_attention_dropout_bwd_plain(
        q, k, v, kv, scale, rate, keep, gout)
    for got, w in zip((qr.grad, kr.grad, vr.grad), want):
        _check(got, w)


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


@pytest.mark.parametrize("D", [7, 64, 768])
def test_k8_scatter_rows_add_colliding(dev, D):
    """K8 with many indices colliding on few rows (the duplicate padding of
    the patch maps); atomics sum in a run-dependent order."""
    rng = np.random.RandomState(9)
    g = torch.from_numpy(rng.randn(2, 1024, D).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.randint(0, 40, (2, 1024))).to(dev)
    _check(gather.scatter_rows_add(g, idx, 257),
           gather.scatter_rows_add_plain(g, idx, 257))
    x = torch.from_numpy(rng.randn(2, 257, D).astype(np.float32)).to(dev)
    x.requires_grad_()
    gather.gather_rows(x, idx).backward(g)
    _check(x.grad, gather.scatter_rows_add_plain(g, idx, 257))


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
