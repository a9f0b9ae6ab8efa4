"""PyTorch port vs the JAX package: the training attention's saved-state
contract (K5 returns out, the row logsumexp and the packed keep bits; K6
reads them).

The plain versions are the CPU path of the wrappers and the oracles the
CUDA kernels are held against on the card (test_torch_port_gpu.py,
chip_smoke.py). Here, from numpy inputs made from seeds:
- patch_attention_dropout_fwd_plain: out against the JAX patch_attention
  (Pallas, interpret mode) at rate 0 within 1e-5 * max(1, |ref|); lse
  against a float64 logsumexp of the masked logits within 1e-5 * max(1,
  |ref|); the packed bits bit-equal to philox_keep_mask;
- patch_attention_dropout_bwd_plain: against the recomputing plain
  backward (patch_attention_dropout_vjp_plain, fed philox_keep_mask) at
  rates 0, 0.1 and 0.5, and against jax.vjp of patch_attention at rate 0,
  within 1e-4 * max(1, |ref|) (fp32, other summation orders);
- a patch with no valid key, forward and backward, by formula.
Every input set has such a patch (patch 0) and a patch with few keys.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robot3dlotus_tpu.ops import pallas_attention as jattn
from robot3dlotus_tpu_torch.ops import attention

HEAD_DIMS = (8, 16, 24, 32)


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, name=""):
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=0, err_msg=name,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _inputs(seed, G, H, P, Dh):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(G, H, P, Dh).astype(np.float32)
                  for _ in range(4))
    kv = rng.rand(G, P) > 0.25
    kv[0] = False              # no valid key: uniform weights
    kv[1] = False
    kv[1, :3] = True           # few valid keys
    return q, k, v, kv, g


def _saved(q, k, v, kv, scale, rate, seed):
    """(out, lse, bits) of the plain forward on numpy inputs."""
    return attention.patch_attention_dropout_fwd_plain(
        T(q), T(k), T(v), T(kv), scale, rate, seed)


@pytest.mark.parametrize("G,H,P,Dh", [(3, 2, 128, 32), (4, 2, 48, 8),
                                      (3, 2, 100, 24), (2, 3, 16, 16)])
def test_fwd_plain_matches_jax_at_rate0(G, H, P, Dh):
    q, k, v, kv, _ = _inputs(1, G, H, P, Dh)
    scale = Dh ** -0.5
    out, lse, bits = _saved(q, k, v, kv, scale, 0.0, 9)
    ref = jattn.patch_attention(*map(jnp.asarray, (q, k, v, kv)), scale,
                                True)
    _close(out, ref, 1e-5, "out")
    logits = np.einsum("ghpd,ghqd->ghpq", (q * np.float32(scale)).astype(
        np.float64), k.astype(np.float64))
    logits = np.where(kv[:, None, None, :], logits, -1e9)
    mx = logits.max(-1, keepdims=True)
    want = (mx + np.log(np.exp(logits - mx).sum(-1, keepdims=True)))[..., 0]
    _close(lse, want, 1e-5, "lse")
    assert bits.dtype == torch.int32
    assert tuple(bits.shape) == (G, H, P, (P + 31) // 32)
    assert attention.unpack_keep_bits(bits, P).all()


@pytest.mark.parametrize("P", [128, 48, 100, 37])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_fwd_plain_bits_are_the_philox_mask(P, rate):
    """The packed bits, unpacked, are philox_keep_mask bit for bit (P not
    a multiple of 32 leaves a ragged last word, P = 37 rows that start
    inside a generator call); out is the recomputing plain forward fed
    that mask."""
    G, H, Dh, seed = 3, 2, 16, 77
    q, k, v, kv, _ = _inputs(2, G, H, P, Dh)
    out, _, bits = _saved(q, k, v, kv, 0.25, rate, seed)
    keep = attention.philox_keep_mask(seed, G, H, P, rate)
    assert torch.equal(attention.unpack_keep_bits(bits, P), keep)
    assert torch.equal(bits, attention.pack_keep_bits(keep))
    _close(out, attention.patch_attention_dropout_plain(
        T(q), T(k), T(v), T(kv), 0.25, rate, keep), 1e-6, "out")


@pytest.mark.parametrize("P", [1, 31, 32, 33, 128])
def test_pack_keep_bits_layout(P):
    """Bit j % 32 of word j // 32 is keep[..., j]; the int32 words hold
    the uint32 pattern (bit 31 set reads negative); unpack inverts pack."""
    keep = torch.from_numpy(np.random.RandomState(P).rand(3, 2, P) > 0.5)
    bits = attention.pack_keep_bits(keep)
    assert tuple(bits.shape) == (3, 2, (P + 31) // 32)
    assert torch.equal(attention.unpack_keep_bits(bits, P), keep)
    words = bits.numpy().astype(np.int64) & 0xFFFFFFFF
    for j in range(P):
        np.testing.assert_array_equal((words[..., j // 32] >> (j % 32)) & 1,
                                      keep[..., j].numpy())
    one = torch.zeros(P, dtype=torch.bool)
    one[P - 1] = True
    word = int(attention.pack_keep_bits(one)[-1]) & 0xFFFFFFFF
    assert word == 1 << ((P - 1) % 32)


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_bwd_plain_matches_recomputing_plain(rate, Dh):
    """K6's oracle (lse, bits and out read back) against the recomputing
    backward fed the same Philox mask."""
    G, H, P, seed = 3, 2, 64, 4242
    q, k, v, kv, g = _inputs(3 + Dh, G, H, P, Dh)
    scale = Dh ** -0.5
    out, lse, bits = _saved(q, k, v, kv, scale, rate, seed)
    got = attention.patch_attention_dropout_bwd_plain(
        T(q), T(k), T(v), T(kv), out, lse, bits, T(g), scale, rate)
    keep = attention.philox_keep_mask(seed, G, H, P, rate)
    want = attention.patch_attention_dropout_vjp_plain(
        T(q), T(k), T(v), T(kv), scale, rate, keep, T(g))
    for a, b, name in zip(got, want, "qkv"):
        _close(a, b.numpy(), 1e-4, f"d{name}")


@pytest.mark.parametrize("Dh", HEAD_DIMS)
def test_bwd_plain_matches_jax_vjp_at_rate0(Dh):
    G, H, P = 3, 2, 32
    q, k, v, kv, g = _inputs(7 + Dh, G, H, P, Dh)
    scale = Dh ** -0.5
    out, lse, bits = _saved(q, k, v, kv, scale, 0.0, 1)
    got = attention.patch_attention_dropout_bwd_plain(
        T(q), T(k), T(v), T(kv), out, lse, bits, T(g), scale, 0.0)
    _, vjp = jax.vjp(lambda a, b, c: jattn.patch_attention(
        a, b, c, jnp.asarray(kv), scale, True), *map(jnp.asarray, (q, k, v)))
    for a, b, name in zip(got, vjp(jnp.asarray(g)), "qkv"):
        _close(a, b, 1e-4, f"d{name}")


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_patch_with_no_valid_key(rate):
    """Patch 0 has no valid key: every probability is 1 / P, lse is -1e9
    (log P is below fp32's resolution there), out = (kept / P) v /
    (1 - rate); no gradient reaches q or k, dv = (kept / P / (1 - rate))^T
    g. The autograd path on CPU tensors gives the same gradients."""
    G, H, P, Dh, seed = 2, 2, 40, 8, 5
    q, k, v, kv, g = _inputs(11, G, H, P, Dh)
    kv[1] = True
    out, lse, bits = _saved(q, k, v, kv, 0.3, rate, seed)
    keep = attention.unpack_keep_bits(bits, P)[0].double().numpy()
    w = keep / P / (1.0 - rate)
    _close(out[0], np.einsum("hpq,hqd->hpd", w, v[0]), 1e-5, "out")
    assert bool((lse[0] == -1e9).all())
    dq, dk, dv = attention.patch_attention_dropout_bwd_plain(
        T(q), T(k), T(v), T(kv), out, lse, bits, T(g), 0.3, rate)
    assert not dq[0].any() and not dk[0].any()
    _close(dv[0], np.einsum("hpq,hpd->hqd", w, g[0]), 1e-5, "dv")
    ts = [T(a).requires_grad_() for a in (q, k, v)]
    attention.patch_attention_dropout(*ts, T(kv), 0.3, rate, seed).backward(
        T(g))
    for t, want, name in zip(ts, (dq, dk, dv), "qkv"):
        _close(t.grad, want.numpy(), 1e-6, f"autograd d{name}")
