"""PyTorch port vs the JAX package: the Concat variant's wide stem conv.

Under SimplePolicyPTV3Concat the k = 5 stem reads the point features and
the context vector, 7 + 256 = 263 channels, which the JAX package convolves
with its streaming XLA scan (`sparse_conv._subm_conv_streaming`) and the
port with K2 (forward and mirrored dx) and K7, extended to 125 taps and
to channel counts that are not multiples of 4. Here, on the CPU:
  * the plain versions (K2's and K7's oracles and CPU path) against the
    JAX streaming conv and its jax.vjp in x and W, at K = 125, Cin = 263,
    on a cloud with duplicate voxels, within 1e-4 abs in fp32;
  * the zero-channel padding the CUDA wrappers apply (x and W to a
    multiple of 4 channels, the padded outputs dropped) is exact;
  * the plans at 125 taps, enumerated in numpy: K2's tap ranges cover every
    tap once in ascending order and its shared memory fits an SM, K7's row
    ranges cover every row once and its compacted lists fit the scratch;
  * one whole train step of SimplePolicyPTV3Concat (txt_reduce attn, the
    pose and step embeddings in the context vector) against the JAX
    make_train_step: the text projection learns only through the stem
    conv's input gradient, so its gradient is held there too.
The kernels themselves: the gpu-marked cases of test_torch_port_gpu.py
and chip_smoke.py's concat phase.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from robot3dlotus_tpu.ops.sparse_conv import (_subm_conv_streaming,
                                              build_neighbor_map)
from robot3dlotus_tpu_torch.ops import conv
from robot3dlotus_tpu_torch.ops.sparse_conv import (NeighborMap,
                                                    subm_conv_apply)
from test_torch_port_variants import (LOSS, check_train_step, jax_policy,
                                      model_cfg, policy_batch)
from robot3dlotus_tpu.models.simple_policy import compute_loss as jloss
from robot3dlotus_tpu_torch.models.simple_policy import compute_loss

ATOL = 1e-4
K, CIN, COUT = 125, 263, 64
# H100: 227 KB of shared memory a block can opt into
SMEM_PER_BLOCK = 232448


def T(a):
    return torch.from_numpy(np.array(a))


def _case(seed=0, B=2, N=48, span=5):
    rng = np.random.RandomState(seed)
    gc = rng.randint(0, span, (B, N, 3)).astype(np.int32)
    mask = np.arange(N)[None] < np.array([[N], [N - 9]])[:B]
    nm = build_neighbor_map(jnp.asarray(gc), jnp.asarray(mask), 5, 4,
                            extent=16)
    x = (rng.randn(B, N, CIN) * mask[..., None]).astype(np.float32)
    w = (rng.randn(K, CIN, COUT) / np.sqrt(K * CIN)).astype(np.float32)
    g = rng.randn(B, N, COUT).astype(np.float32)
    return nm, x, w, g


def test_wide_stem_plain_matches_jax_streaming_conv_and_vjp():
    nm, x, w, g = _case()
    assert int(np.asarray(nm.ok).sum()) > 2 * x.shape[1]
    out, vjp = jax.vjp(lambda a, b: _subm_conv_streaming(a, nm, b),
                       jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    idx, ok = T(nm.idx), T(nm.ok)
    xt = T(x).requires_grad_()
    wt = T(w).requires_grad_()
    got = subm_conv_apply(xt, NeighborMap(idx, ok), wt)
    got.backward(T(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), atol=ATOL,
                               rtol=0)
    # the pieces the CUDA path runs: K7's oracle and the exact dx
    np.testing.assert_allclose(
        conv.conv_weight_grad_plain(T(x), idx, ok, T(g)).numpy(),
        np.asarray(jdw), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        conv.conv_input_grad(T(g), idx, ok, T(w)).numpy(), np.asarray(jdx),
        atol=ATOL, rtol=0)


@pytest.mark.parametrize("cin,cout", [(263, 64), (64, 263), (7, 6)])
def test_zero_channel_padding_is_exact(cin, cout):
    """What _conv_forward and conv_weight_grad do before a launch: x and W
    padded with zero channels to multiples of 4, the padded outputs (and
    dW rows) dropped, gives the unpadded results bit for bit."""
    nm, x, _, _ = _case(seed=1)
    rng = np.random.RandomState(2)
    x = T(rng.randn(2, 48, cin).astype(np.float32))
    w = T((rng.randn(K, cin, cout) * 0.05).astype(np.float32))
    g = T(rng.randn(2, 48, cout).astype(np.float32))
    idx, ok = T(nm.idx), T(nm.ok)
    pin, pout = -cin % 4, -cout % 4
    padded = conv.subm_conv_plain(F.pad(x, (0, pin)), idx, ok,
                                  F.pad(w, (0, pout, 0, pin)))
    assert padded.shape[-1] % 4 == 0
    assert torch.equal(padded[..., :cout], conv.subm_conv_plain(x, idx, ok,
                                                                w))
    assert not padded[..., cout:].any()
    dw = conv.conv_weight_grad_plain(F.pad(x, (0, pin)), idx, ok, g)
    assert torch.equal(dw[:, :cin], conv.conv_weight_grad_plain(x, idx, ok,
                                                                g))


@pytest.mark.parametrize("B,N,cout", [(32, 4096, 64), (4, 4096, 64),
                                      (1, 4096, 64), (1, 4096, 264),
                                      (1, 37, 64)])
def test_k2_tap_ranges_at_125_taps(B, N, cout):
    """The split count conv_tap_splits gives the stem's calls (at most K),
    and the ranges csrc/conv.cu cuts from it (range s: [s K / splits,
    (s + 1) K / splits)): non-empty, every tap once, ascending; each block
    then sums its taps in ascending order and the reduce adds the ranges
    in order."""
    splits = conv.conv_tap_splits(B, N, K, cout)
    assert splits in (1, K)
    blocks = -(-N // conv.CONV_ROWS) * -(-cout // conv.CONV_COLS) * B
    assert (splits == 1) == (4 * blocks >= conv.CONV_TARGET_BLOCKS)
    ranges = [(s * K // splits, (s + 1) * K // splits)
              for s in range(splits)]
    taps = [k for b, e in ranges for k in range(b, e)]
    assert taps == list(range(K)) and all(e > b for b, e in ranges)


def test_k2_shared_memory_fits_at_125_taps():
    """csrc/conv.cu's Smem<kMaxK> (fp32 accumulator, the map rows of the
    tile in a union with the pipeline's ring, and the per-tap row lists),
    counted in bytes: the 27-tap instance fits two blocks an SM, the
    125-tap one one block (under the 227 KB a block may opt into), and the
    lists' positions fit a byte (kTM = 128 rows a tile)."""
    tm, kc, tn, stages = conv.CONV_ROWS, 32, conv.CONV_COLS, 2

    def smem(max_k):
        acc = tm * (tn + 4) * 4
        pipe = stages * (tm * (kc + 8) + kc * (tn + 4)) * 4
        tile_map = tm * max_k * (4 + 1)
        lists = max_k * tm * (4 + 1) + max_k * (tm // 32) * 4 + 2 * max_k * 4
        return acc + max(pipe, tile_map) + lists + 4

    assert conv.CONV_MAX_TAPS == K
    assert 2 * smem(27) <= SMEM_PER_BLOCK
    assert 2 * smem(K) > SMEM_PER_BLOCK >= smem(K)
    assert tm <= 256


@pytest.mark.parametrize("B,N", [(32, 4096), (4, 4096), (1, 4096), (2, 37)])
def test_k7_plan_at_125_taps_covers_each_row_once(B, N):
    """K7 on the wide stem runs its compacted path on x padded to 264
    channels: the row ranges cover every row once, in order, and the
    scratch holds the live lists (row and source per live link, counts)
    and, with more than one range, the partial dW."""
    cin = CIN + (-CIN % 4)
    assert CIN >= conv.WGRAD_PAD_MIN_CIN and cin % 4 == 0
    splits, per, nbytes = conv.weight_grad_plan(B, N, K, cin, COUT)
    R = B * N
    ranges = [(s * per, min((s + 1) * per, R)) for s in range(splits)]
    rows = np.concatenate([np.arange(b, e) for b, e in ranges])
    np.testing.assert_array_equal(rows, np.arange(R))
    assert all(e > b for b, e in ranges)
    lists = -(-4 * (2 * K * R + K * splits) // 16) * 16
    part = 4 * splits * K * cin * COUT if splits > 1 else 0
    assert nbytes == lists + part
    # the compacted path's tiles: 125 taps x 5 channel tiles of 64 already
    # fill the card at one range
    if R >= conv.WGRAD_MIN_ROWS * 2:
        assert splits == 1


def test_concat_train_step_matches_jax(monkeypatch):
    cfg = model_cfg("SimplePolicyPTV3Concat", act={
        "txt_reduce": "attn", "use_ee_pose": True, "use_step_id": True})
    act = cfg["action_config"]
    check_train_step(
        cfg, jax_policy(cfg), lambda p, b: jloss(p, b, act, LOSS),
        lambda p, b: compute_loss(p, b, act, LOSS), policy_batch(seed=3),
        [[1, 3, 0, 2], [3, 2, 1, 0]], monkeypatch,
        must_learn=("txt_fc.weight", "txt_attn_fc.weight",
                    "pose_embedding.rot_embedding.weight",
                    "stepid_embedding.weight",
                    "ptv3_model.embedding_stem_conv.weight"))
