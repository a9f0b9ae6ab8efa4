"""PyTorch port vs the JAX package: the sentinel contract of K4 / K8 and the
decoder's unpool without a pad.

In the port, K4 (gather_rows) and K8 (scatter_rows_add) take K9's contract:
an index outside [0, N) gathers a zero row, and its cotangent is dropped.
The JAX package's K4 takes only indices in [0, N), so its unpool_gather
appends a zero row at child_cap and gathers from that copy. These tests
hold the port's plain versions (the CPU path of the wrappers and the
oracles the CUDA kernels are held against on the card) to the JAX functions
on the padded input, from the same numpy inputs. Gathers must be
bit-equal; gradients agree within 1e-4 * max(1, |ref|) (fp32 sums in
another order).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robot3dlotus_tpu.ops import pallas_gather as jgather
from robot3dlotus_tpu.ops import pooling as jpool
from robot3dlotus_tpu_torch.ops import gather
from robot3dlotus_tpu_torch.ops import pooling as tpool

ATOL = 1e-4


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    want = np.asarray(want)
    tol = ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0)


def _sentinel_rows(rng, B, M, N):
    """(B, M) int64 indices in [0, N) with duplicates, a quarter of them at
    the sentinel N and a few other out-of-range values."""
    idx = rng.randint(0, N, (B, M))
    idx[rng.rand(B, M) < 0.25] = N
    idx[:, :3] = [-1, N + 5, -7]
    return idx


@pytest.mark.parametrize("D,child_cap,seed", [(8, 24, 0), (64, 24, 1),
                                              (96, 5, 2)])
def test_unpool_gather_without_pad_matches_jax(D, child_cap, seed):
    """The port's unpool gathers from the child features directly (K4's
    sentinel at child_cap); the JAX package pads a zero row and gathers
    from the copy. Forward bit-equal, gradient into (B, child_cap, D) with
    the dropped rows' cotangents gone."""
    rng = np.random.RandomState(seed)
    B, N = 2, 64
    child = rng.randn(B, child_cap, D).astype(np.float32)
    cluster = rng.randint(0, child_cap, (B, N))
    cluster[rng.rand(B, N) < 0.25] = child_cap       # dropped / padding
    cluster[:, 10:20] = cluster[:, :1]               # duplicate clusters
    g = rng.randn(B, N, D).astype(np.float32)
    want, vjp = jax.vjp(lambda c: jpool.unpool_gather(
        c, jnp.asarray(cluster), child_cap), jnp.asarray(child))
    ct = T(child).requires_grad_()
    got = tpool.unpool_gather(ct, T(cluster), child_cap)
    got.backward(T(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert not got[T(cluster) == child_cap].any()
    assert ct.grad.shape == (B, child_cap, D)
    _close(ct.grad, vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("D", [7, 8, 128])
def test_sentinel_gather_and_scatter_match_jax_on_padded_x(D):
    """gather_rows_plain with out-of-range indices against JAX permute_rows
    (its XLA path and the Pallas kernel in interpret mode) on x with a zero
    row appended and every out-of-range index sent to it; the backward
    (scatter_rows_add_plain, and autograd of gather_rows on the CPU)
    against jax.vjp of the same, whose cotangent for the appended row is
    not part of dx: the sentinel rows' cotangents are dropped."""
    rng = np.random.RandomState(3)
    B, N, M = 2, 33, 64
    x = rng.randn(B, N, D).astype(np.float32)
    idx = _sentinel_rows(rng, B, M, N)
    g = rng.randn(B, M, D).astype(np.float32)
    sel = np.where((idx >= 0) & (idx < N), idx, N).astype(np.int32)

    def jfn(xx, impl):
        padded = jnp.concatenate([xx, jnp.zeros((B, 1, D), xx.dtype)], 1)
        return jgather.permute_rows(padded, jnp.asarray(sel), impl=impl)
    got = gather.gather_rows_plain(T(x), T(idx))
    xla, vjp = jax.vjp(lambda xx: jfn(xx, "xla"), jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    _close(got, jfn(jnp.asarray(x), "pallas_interpret"))
    want_dx = vjp(jnp.asarray(g))[0]
    _close(gather.scatter_rows_add_plain(T(g), T(idx), N), want_dx)
    xt = T(x).requires_grad_()
    gather.gather_rows(xt, T(idx)).backward(T(g))
    _close(xt.grad, want_dx)
    # the dropped rows' cotangents reach no row of dx
    keep = T((idx >= 0) & (idx < N))[..., None]
    np.testing.assert_array_equal(
        gather.scatter_rows_add_plain(T(g), T(idx), N).numpy(),
        gather.scatter_rows_add_plain(T(g) * keep, T(idx), N).numpy())


@pytest.mark.parametrize("fn", ["gather_rows", "gather_rows_smallc",
                                "scatter_rows_add",
                                "scatter_rows_smallc_add"])
def test_int32_and_int64_indices_identical(fn):
    """Every wrapper takes int32 and int64 indices (the kernels take both,
    so the wrappers never cast) with the same result, sentinel rows
    included."""
    rng = np.random.RandomState(4)
    B, N, M, C = 2, 40, 96, 6
    idx = _sentinel_rows(rng, B, M, N)
    if fn.startswith("gather"):
        args = (T(rng.randn(B, N, C).astype(np.float32)),)
    else:
        args = (T(rng.randn(B, M, C).astype(np.float32)),)
    outs = []
    for dt in (torch.int32, torch.int64):
        i = T(idx).to(dt)
        outs.append(getattr(gather, fn)(*args, i) if fn.startswith("gather")
                    else getattr(gather, fn)(*args, i, N))
    assert outs[0].shape == outs[1].shape
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())
