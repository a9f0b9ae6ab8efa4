"""PyTorch port vs the JAX package: the four kernels of the policy path.

Each port kernel's plain PyTorch version (the CPU path of its wrapper and
the oracle its CUDA kernel is held against) is compared, on the same numpy
inputs, with the JAX function two ways: the Pallas kernel in interpret mode
and its exact XLA path. Tolerance 1e-4 abs in fp32 (the bar of
test_recorded_fixture_parity.py). The kernels against their plain versions
on the card: test_torch_port_gpu.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from robot3dlotus_tpu.ops import pallas_attention as jattn
from robot3dlotus_tpu.ops import pallas_gather as jgather
from robot3dlotus_tpu.ops import pallas_stem as jstem
from robot3dlotus_tpu.ops.pallas_conv import (build_window_map,
                                              subm_conv_windowed)
from robot3dlotus_tpu.ops.sparse_conv import (build_neighbor_map,
                                              subm_conv_apply)
from robot3dlotus_tpu_torch.ops import attention, conv, gather, stem

ATOL = 1e-4


def T(a):
    return torch.from_numpy(np.array(a))


def _attn_inputs(seed, G, H, P, Dh):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(G, H, P, Dh).astype(np.float32) for _ in range(3))
    kv = rng.rand(G, P) > 0.25
    kv[0] = False          # a fully masked patch: uniform weights, no NaN
    kv[1, :5] = True
    return q, k, v, kv


@pytest.mark.parametrize("G,H,P,Dh", [(4, 2, 16, 8), (3, 2, 32, 24),
                                      (2, 4, 16, 32)])
def test_k1_patch_attention_plain_matches_jax(G, H, P, Dh):
    q, k, v, kv = _attn_inputs(0, G, H, P, Dh)
    scale = Dh ** -0.5
    got = attention.patch_attention(T(q), T(k), T(v), T(kv), scale).numpy()
    assert np.isfinite(got).all()
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv))
    pallas = jattn.patch_attention(*jargs, scale, True)
    xla = jattn._xla_reference(*jargs, scale)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(xla), atol=ATOL, rtol=0)


def _conv_inputs(seed, B=2, N=64, C=16, depth=4):
    rng = np.random.RandomState(seed)
    gcs = []
    for _ in range(B):
        flat = rng.choice(16 ** 3, N, replace=False)
        gcs.append(np.stack(np.unravel_index(flat, (16,) * 3), -1))
    gc = np.asarray(gcs, np.int32)
    counts = np.array([N, N - 11][:B])
    mask = np.arange(N)[None] < counts[:, None]
    feat = (rng.randn(B, N, C) * mask[..., None]).astype(np.float32)
    w = (rng.randn(27, C, C) * 0.2).astype(np.float32)
    bias = rng.randn(C).astype(np.float32)
    return gc, mask, feat, w, bias


@pytest.mark.parametrize("C", [8, 16, 24])
def test_k2_subm_conv_plain_matches_jax(C):
    gc, mask, feat, w, bias = _conv_inputs(1, C=C)
    wmap = build_window_map(jnp.asarray(gc), jnp.asarray(mask), 3, 4,
                            halo=64)
    assert int(jnp.max(wmap.far_dropped)) == 0
    nm = wmap.nmap
    got = conv.subm_conv(T(feat), T(nm.idx), T(nm.ok),
                         T(w), T(bias)).numpy()
    pallas = subm_conv_windowed(jnp.asarray(feat), wmap, jnp.asarray(w),
                                jnp.asarray(bias), interpret=True)
    xla = subm_conv_apply(jnp.asarray(feat), nm, jnp.asarray(w),
                          jnp.asarray(bias))
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(xla), atol=ATOL, rtol=0)


@pytest.mark.parametrize("cin", [7, 8])
def test_k3_stem_conv_plain_matches_jax(cin):
    """The windowed Pallas gather (N = 256: one window, no far links) plus
    the stencil einsum, and the exact streaming XLA conv."""
    rng = np.random.RandomState(2)
    B, N = 2, 256
    gc = rng.randint(0, 9, (B, N, 3)).astype(np.int32)
    mask = np.arange(N)[None] < np.array([[N], [N - 40]])
    nm = build_neighbor_map(jnp.asarray(gc), jnp.asarray(mask), 5, 4,
                            extent=16)
    feat = rng.randn(B, N, cin).astype(np.float32)
    w = (rng.randn(125, cin, 32) * 0.1).astype(np.float32)
    got = stem.stem_conv(T(feat), T(nm.idx), T(nm.ok),
                         T(w)).numpy()
    g, far = jstem.stem_gather_windowed(jnp.asarray(feat), nm,
                                        interpret=True)
    assert far is None
    g = jnp.where(nm.ok[..., None], g, 0.0)
    pallas = jnp.einsum("bnkc,kcd->bnd", g, jnp.asarray(w))
    xla = subm_conv_apply(jnp.asarray(feat), nm, jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(xla), atol=ATOL, rtol=0)


@pytest.mark.parametrize("D", [8, 128, 7])
def test_k4_gather_rows_plain_matches_jax(D):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 33, D).astype(np.float32)
    idx = rng.randint(0, 33, (2, 64)).astype(np.int32)
    got = gather.gather_rows(T(x), T(idx)).numpy()
    xla = jgather.permute_rows(jnp.asarray(x), jnp.asarray(idx), impl="xla")
    np.testing.assert_array_equal(got, np.asarray(xla))
    pallas = jgather.permute_rows(jnp.asarray(x), jnp.asarray(idx),
                                  impl="pallas_interpret")
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL, rtol=0)
