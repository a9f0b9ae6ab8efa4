"""The PyTorch port on a CUDA card: each kernel against its plain version,
and the card's grid coordinates against the host presort's.

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
