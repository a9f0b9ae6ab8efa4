"""PyTorch port vs the JAX package: structural ops of the policy path.

Serialization codes, stencil neighbour maps (dense-extent and sorted paths,
duplicate coordinates), patch pad maps, pooling maps, segment reductions and
unpool_gather. Integer maps must be bit-equal; float reductions agree to
1e-6. Inputs come from numpy seeds and go to both packages.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from robot3dlotus_tpu.ops import serialization as jser
from robot3dlotus_tpu.ops import sparse_conv as jsc
from robot3dlotus_tpu.ops import patching as jpatch
from robot3dlotus_tpu.ops import pooling as jpool
from robot3dlotus_tpu_torch.ops import serialization as tser
from robot3dlotus_tpu_torch.ops import sfc_np
from robot3dlotus_tpu_torch.ops import sparse_conv as tsc
from robot3dlotus_tpu_torch.ops import patching as tpatch
from robot3dlotus_tpu_torch.ops import pooling as tpool


def _cloud(seed, B=2, N=96, span=12, dup=True):
    """Grid coords in [0, span)^3 with some duplicate voxels and a short
    second cloud (padding rows hold junk coordinates)."""
    rng = np.random.RandomState(seed)
    gc = rng.randint(0, span, (B, N, 3)).astype(np.int32)
    if dup:
        gc[:, 5] = gc[:, 2]       # duplicate coordinates
        gc[:, 40] = gc[:, 7]
    counts = np.array([N, N - 23][:B], np.int32)
    mask = np.arange(N)[None] < counts[:, None]
    return gc, mask, counts


@pytest.mark.parametrize("order", list(jser.SFC_ORDERS))
def test_sfc_codes_bit_equal(order):
    rng = np.random.RandomState(0)
    gc = rng.randint(0, 1 << 10, (3, 257, 3)).astype(np.int32)
    want = np.asarray(jser.sfc_encode(jnp.asarray(gc), order, 10))
    got = tser.sfc_encode(torch.from_numpy(gc), order, 10).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sfc_np.sfc_encode_np(gc, order, 10), want)


def test_serialize_codes_sentinel_and_argsort_inverse():
    gc, mask, _ = _cloud(1, span=1 << 10, dup=False)
    want = np.asarray(jser.serialize_codes(jnp.asarray(gc), jnp.asarray(mask),
                                           10))
    got = tser.serialize_codes(torch.from_numpy(gc), torch.from_numpy(mask),
                               10)
    np.testing.assert_array_equal(got.numpy(), want)
    jo, ji = jser.argsort_with_inverse(jnp.asarray(want[2]))
    to, ti = tser.argsort_with_inverse(got[2])
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("kernel_size,extent", [(3, 16), (3, None),
                                                (5, 16), (5, 0), (3, 8)])
def test_neighbor_map_bit_equal(kernel_size, extent):
    """extent=16 takes the dense table, None/0 the sorted path, and 8 (some
    coordinates out of extent) the sorted fallback; duplicates resolve to
    the lowest index on every path."""
    gc, mask, _ = _cloud(2)
    want = jsc.build_neighbor_map(jnp.asarray(gc), jnp.asarray(mask),
                                  kernel_size, 4, extent=extent)
    got = tsc.build_neighbor_map(torch.from_numpy(gc), torch.from_numpy(mask),
                                 kernel_size, 4, extent=extent)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    assert got.idx.dtype == torch.int32
    np.testing.assert_array_equal(tsc.stencil_offsets(kernel_size),
                                  jsc.stencil_offsets(kernel_size))


@pytest.mark.parametrize("patch", [16, 32])
def test_pad_maps_and_dup_pad(patch):
    counts = np.array([96, 75, 9, 0], np.int32)
    ws, wk = jpatch.build_pad_maps(jnp.asarray(counts), 96, patch)
    ts, tk = tpatch.build_pad_maps(torch.from_numpy(counts), 96, patch)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
    x = np.random.RandomState(3).randn(4, 96, 5).astype(np.float32)
    want = jpatch.dup_pad_identity(jnp.asarray(x), jnp.asarray(counts), patch)
    got = tpatch.dup_pad_identity(torch.from_numpy(x),
                                  torch.from_numpy(counts), patch)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # another order than the frame's: gather into it and scatter back
    codes = np.random.RandomState(4).randint(0, 999, (4, 96)).astype(np.int32)
    jo, ji = jser.argsort_with_inverse(jnp.asarray(codes))
    to, ti = tser.argsort_with_inverse(torch.from_numpy(codes))
    want = jpatch.gather_sorted(jnp.asarray(x), jo, ws)
    got = tpatch.gather_sorted(torch.from_numpy(x), to, ts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tpatch.scatter_back(got, ti).numpy(),
        np.asarray(jpatch.scatter_back(want, ji)))


def _sorted_codes(seed, child_cap):
    gc, mask, counts = _cloud(seed, span=16)
    codes = np.asarray(jser.serialize_codes(jnp.asarray(gc),
                                            jnp.asarray(mask), 4))[0]
    codes = np.sort(codes, axis=-1)
    return codes, counts


@pytest.mark.parametrize("child_cap", [48, 20])
def test_pool_maps_and_segment_reduce(child_cap):
    """child_cap=20 overflows: dropped segments must match too."""
    codes, counts = _sorted_codes(4, child_cap)
    jm = jpool.build_pool_maps(jnp.asarray(codes), None, None,
                               jnp.asarray(counts), child_cap)
    tm = tpool.build_pool_maps(torch.from_numpy(codes),
                               torch.from_numpy(counts).long(), child_cap)
    for name in ("seg_sorted", "head_sorted_pos", "child_mask",
                 "child_counts"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)), name)
    # sorted-resident frame: each point's cluster is its segment
    np.testing.assert_array_equal(tm.seg_sorted.numpy(),
                                  np.asarray(jm.cluster))
    vals = np.random.RandomState(5).randn(*codes.shape, 6).astype(np.float32)
    for red in ("max", "mean"):
        want = jpool.segment_reduce(jnp.asarray(vals), jm, child_cap, red)
        got = tpool.segment_reduce(torch.from_numpy(vals), tm, child_cap, red)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)
    gcs = np.random.RandomState(6).randint(0, 99, (*codes.shape, 3))
    np.testing.assert_array_equal(
        tpool.gather_heads(torch.from_numpy(gcs), tm).numpy(),
        np.asarray(jpool.gather_heads(jnp.asarray(gcs), None, jm)))
    child = np.random.RandomState(7).randn(2, child_cap, 8).astype(np.float32)
    want = jpool.unpool_gather(jnp.asarray(child), jm.cluster, child_cap)
    got = tpool.unpool_gather(torch.from_numpy(child), tm.seg_sorted,
                              child_cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_voxelize_bit_equal(dtype):
    """float64 takes the JAX package's numpy path, float32 its native one."""
    from robot3dlotus_tpu.ops.voxel import voxelize_pcd_np as jvox
    from robot3dlotus_tpu_torch.ops.voxel import voxelize_pcd_np as tvox
    rng = np.random.RandomState(8)
    xyz = rng.uniform(-0.4, 0.6, (20000, 3)).astype(dtype)
    xyz[:500] = xyz[500:1000] + 1e-4          # shared voxels
    for got, want in zip(tvox(xyz, 0.01), jvox(xyz, 0.01)):
        np.testing.assert_array_equal(got, want)


def test_grid_coord_bit_equal():
    from robot3dlotus_tpu.models.ptv3 import compute_grid_coord as jgrid
    from robot3dlotus_tpu_torch.models.ptv3 import compute_grid_coord as tgrid
    rng = np.random.RandomState(9)
    xyz = rng.uniform(-1.0, 1.0, (2, 4096, 3)).astype(np.float32)
    mask = np.arange(4096)[None] < np.array([[4096], [3000]])
    want = jgrid(jnp.asarray(xyz), jnp.asarray(mask), 0.01, 10)
    got = tgrid(torch.from_numpy(xyz), torch.from_numpy(mask), 0.01, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
