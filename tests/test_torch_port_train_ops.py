"""PyTorch port vs the JAX package: the training pieces below the model.

The backward of each kernel's plain version (the CPU path of its wrapper
and the oracle its CUDA kernel is held against on the card) against the
JAX gradient on the same numpy inputs; the position targets and the loss;
the AdamW update; the synthetic data path. Tolerances, stated per test:
1e-4 * max(1, |ref|) in fp32 (the ROADMAP bar; ATOL below), integer and
boolean outputs bit-equal.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robot3dlotus_tpu.models.simple_policy import (
    build_disc_pos_targets as jtargets, compute_loss as jloss)
from robot3dlotus_tpu.ops import pallas_attention as jattn
from robot3dlotus_tpu.ops import pallas_gather as jgather
from robot3dlotus_tpu.ops.pallas_conv import (build_window_map,
                                              subm_conv_windowed)
from robot3dlotus_tpu.ops.pos_codec import (disc_pos_gt_prob_jnp,
                                            disc_pos_gt_prob_np as jprob_np)
from robot3dlotus_tpu.ops.sparse_conv import (build_neighbor_map,
                                              subm_conv_apply)
from robot3dlotus_tpu.train.datasets.collate import \
    collate_keystep_samples as jcollate
from robot3dlotus_tpu.train.datasets.keystep_dataset import \
    KeystepDataset as JaxKeystepDataset
from robot3dlotus_tpu.train.datasets.store import open_store as jopen_store
from robot3dlotus_tpu.train.optim import build_optimizer as jbuild_optimizer
from robot3dlotus_tpu.train.optim import lr_decay_rate as jdecay
from robot3dlotus_tpu_torch.models.simple_policy import (
    build_disc_pos_targets, compute_loss)
from robot3dlotus_tpu_torch.ops import attention, conv, gather, stem
from robot3dlotus_tpu_torch.ops.pos_codec import (disc_pos_gt_prob,
                                                  disc_pos_gt_prob_np)
from robot3dlotus_tpu_torch.train.datasets.collate import \
    collate_keystep_samples
from robot3dlotus_tpu_torch.train.datasets.keystep_dataset import \
    KeystepDataset
from robot3dlotus_tpu_torch.train.datasets.store import open_store
from robot3dlotus_tpu_torch.train.optim import (FlatAdamW, build_optimizer,
                                                lr_decay_rate)

ATOL = 1e-4


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, name=""):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    tol = ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=name)


# ------------------------------------------------------------ K4 / K8 -----

@pytest.mark.parametrize("D", [8, 128])
def test_gather_rows_grad_with_collisions_matches_jax(D):
    """The backward of gather_rows (scatter_rows_add, K8's plain version)
    against jax.vjp of permute_rows(impl='pallas_interpret'), which reaches
    _permute_bwd_call; 96 of the 128 rows land on 4 source rows, as the
    duplicate padding of the patch maps does."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 40, D).astype(np.float32)
    idx = rng.randint(0, 40, (2, 128)).astype(np.int32)
    idx[:, 32:] = rng.randint(0, 4, (2, 96))
    g = rng.randn(2, 128, D).astype(np.float32)
    xt = T(x).requires_grad_()
    gather.gather_rows(xt, T(idx)).backward(T(g))
    _, vjp = jax.vjp(lambda xx: jgather.permute_rows(
        xx, jnp.asarray(idx), impl="pallas_interpret"), jnp.asarray(x))
    want = vjp(jnp.asarray(g))[0]
    _close(xt.grad, want)
    _close(gather.scatter_rows_add(T(g), T(idx), 40), want)


# ------------------------------------------------------------- K2 / K7 ----

def _unique_cloud(rng, B=2, N=64, C=16, span=16):
    gcs = []
    for _ in range(B):
        flat = rng.choice(span ** 3, N, replace=False)
        gcs.append(np.stack(np.unravel_index(flat, (span,) * 3), -1))
    gc = np.asarray(gcs, np.int32)
    mask = np.arange(N)[None] < np.array([N, N - 11][:B])[:, None]
    feat = (rng.randn(B, N, C) * mask[..., None]).astype(np.float32)
    return gc, mask, feat


def _conv_grads_port(feat, nm, w, bias, g):
    xt, wt, bt = (T(a).requires_grad_() for a in (feat, w, bias))
    conv.subm_conv(xt, T(nm.idx), T(nm.ok), wt, bt).backward(T(g))
    return xt.grad, wt.grad, bt.grad


def _conv_grads_jax(fn, feat, w, bias, g):
    return jax.grad(lambda f, ww, b: jnp.sum(fn(f, ww, b) * g),
                    argnums=(0, 1, 2))(jnp.asarray(feat), jnp.asarray(w),
                                       jnp.asarray(bias))


@pytest.mark.parametrize("C", [8, 24])
def test_subm_conv_grads_match_jax_windowed(C):
    """dx (K2 on the cotangent with the mirrored weight), dW (K7's plain
    version) and dbias against the custom VJP of subm_conv_windowed
    (interpret), on a duplicate-free, hence link-symmetric, map."""
    rng = np.random.RandomState(1)
    gc, mask, feat = _unique_cloud(rng, C=C)
    w = (rng.randn(27, C, C + 8) * 0.2).astype(np.float32)
    bias = rng.randn(C + 8).astype(np.float32)
    g = rng.randn(2, 64, C + 8).astype(np.float32)
    wmap = build_window_map(jnp.asarray(gc), jnp.asarray(mask), 3, 4,
                            halo=64)
    assert int(jnp.max(wmap.far_dropped)) == 0
    got = _conv_grads_port(feat, wmap.nmap, w, bias, g)
    want = _conv_grads_jax(lambda f, ww, b: subm_conv_windowed(
        f, wmap, ww, b, interpret=True), feat, w, bias, g)
    exact = _conv_grads_jax(lambda f, ww, b: subm_conv_apply(
        f, wmap.nmap, ww, b), feat, w, bias, g)
    for a, b, e, name in zip(got, want, exact, ("dx", "dW", "dbias")):
        _close(a, b, name)
        _close(a, e, name)
    _close(conv.conv_weight_grad(T(feat), T(wmap.nmap.idx),
                                 T(wmap.nmap.ok), T(g)), want[1])


def test_conv_dx_is_exact_on_an_asymmetric_map():
    """Two points on one voxel: the lower index owns it, the other has
    links out and none in. The mirrored conv on the raw cotangent (what
    the JAX windowed VJP computes) then differs from the exact adjoint (XLA
    autodiff); the port's dx, which first sums each voxel's cotangents
    onto its owner (conv_input_grad), equals the exact adjoint, and dW
    stays exact."""
    rng = np.random.RandomState(2)
    gc, mask, feat = _unique_cloud(rng, B=1, N=48, C=8)
    gc[0, 5] = gc[0, 3]
    w = (rng.randn(27, 8, 8) * 0.2).astype(np.float32)
    bias = np.zeros(8, np.float32)
    g = rng.randn(1, 48, 8).astype(np.float32)
    wmap = build_window_map(jnp.asarray(gc), jnp.asarray(mask), 3, 4,
                            halo=64)
    nm = wmap.nmap
    got = _conv_grads_port(feat, nm, w, bias, g)
    win = _conv_grads_jax(lambda f, ww, b: subm_conv_windowed(
        f, wmap, ww, b, interpret=True), feat, w, bias, g)
    exact = _conv_grads_jax(lambda f, ww, b: subm_conv_apply(
        f, nm, ww, b), feat, w, bias, g)
    _close(got[0], exact[0], "dx")
    _close(got[1], exact[1], "dW")
    mirrored = conv.subm_conv_plain(T(g), T(nm.idx), T(nm.ok),
                                    conv.mirror_weight(T(w)))
    _close(mirrored, win[0], "mirrored dx vs windowed")
    diff = np.abs(mirrored.numpy() - np.asarray(exact[0])).max(-1)[0]
    assert diff[5] > 1e-2 and diff[3] > 1e-2      # the pair's rows differ
    assert (diff > 1e-4).sum() < 48               # rows far away agree


def test_stem_weight_grad_matches_jax():
    """The stem's dW (K7's plain version at K = 125, Cin 7) against
    jax.grad of the exact XLA stem conv with respect to its weight; with
    the input requiring a gradient too, both gradients (the input's:
    one matmul, then K10's plain version; test_torch_port_stem_vjp.py
    holds it at the release shape)."""
    rng = np.random.RandomState(3)
    gc, mask, feat = _unique_cloud(rng, N=96, C=7, span=8)
    nm = build_neighbor_map(jnp.asarray(gc), jnp.asarray(mask), 5, 3,
                            extent=16)
    w = (rng.randn(125, 7, 32) * 0.1).astype(np.float32)
    g = rng.randn(2, 96, 32).astype(np.float32)
    wt = T(w).requires_grad_()
    stem.stem_conv(T(feat), T(nm.idx), T(nm.ok), wt).backward(T(g))
    want = jax.grad(lambda ww: jnp.sum(subm_conv_apply(
        jnp.asarray(feat), nm, ww) * g))(jnp.asarray(w))
    _close(wt.grad, want)
    ft, wt = T(feat).requires_grad_(), T(w).requires_grad_()
    stem.stem_conv(ft, T(nm.idx), T(nm.ok), wt).backward(T(g))
    want_dx = jax.grad(lambda f: jnp.sum(subm_conv_apply(
        f, nm, jnp.asarray(w)) * g))(jnp.asarray(feat))
    _close(ft.grad, want_dx)
    _close(wt.grad, want)


# ------------------------------------------------------------- K5 / K6 ----

def _attn_inputs(seed, G, H, P, Dh):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(G, H, P, Dh).astype(np.float32)
                  for _ in range(4))
    kv = rng.rand(G, P) > 0.25
    kv[0] = False
    kv[1, :5] = True
    return q, k, v, kv, g


@pytest.mark.parametrize("G,H,P,Dh", [(4, 2, 16, 8), (3, 2, 32, 24)])
def test_attention_dropout_rate0_matches_jax(G, H, P, Dh):
    """patch_attention_dropout at rate 0 (the training attention's plain
    path): forward and (dq, dk, dv) against patch_attention (interpret)."""
    q, k, v, kv, g = _attn_inputs(4, G, H, P, Dh)
    scale = Dh ** -0.5
    qt, kt, vt = (T(a).requires_grad_() for a in (q, k, v))
    out = attention.patch_attention_dropout(qt, kt, vt, T(kv), scale, 0.0,
                                            123)
    out.backward(T(g))
    ref, vjp = jax.vjp(lambda a, b, c: jattn.patch_attention(
        a, b, c, jnp.asarray(kv), scale, True), *map(jnp.asarray, (q, k, v)))
    _close(out, ref, "out")
    for got, want, name in zip((qt.grad, kt.grad, vt.grad),
                               vjp(jnp.asarray(g)), "qkv"):
        _close(got, want, f"d{name}")


def _jax_drop_bwd(q, k, v, kv, g, keep, scale, rate):
    """_attn_drop_bwd_kernel's math over every (g, h), in jnp, with the
    keep mask given and ds zeroed at masked keys, as autodiff through the
    jnp.where on the logits does (the kernel itself differs only in a
    patch with no valid key, patch 0 here)."""
    logits = jnp.einsum("ghpd,ghqd->ghpq", q * scale, k)
    logits = jnp.where(kv[:, None, None, :], logits, jattn.NEG_INF)
    a = jax.nn.softmax(logits, axis=-1)
    inv_keep = 1.0 / (1.0 - rate)
    ad = jnp.where(keep, a * inv_keep, 0.0)
    out = jnp.einsum("ghpq,ghqd->ghpd", ad, v)
    dv = jnp.einsum("ghpq,ghpd->ghqd", ad, g)
    da = jnp.where(keep, jnp.einsum("ghpd,ghqd->ghpq", g, v) * inv_keep, 0.0)
    ds = a * (da - jnp.sum(da * a, axis=-1, keepdims=True))
    ds = jnp.where(kv[:, None, None, :], ds, 0.0)
    dq = jnp.einsum("ghpq,ghqd->ghpd", ds, k) * scale
    dk = jnp.einsum("ghpq,ghpd->ghqd", ds, q) * scale
    return out, dq, dk, dv


def test_attention_dropout_plain_matches_jax_kernel_math():
    """The plain forward and backward with an injected keep mask (the
    kernels' Philox mask) against a jnp transcription of the JAX dropout
    kernels; autograd of the plain forward agrees with the plain
    backward."""
    G, H, P, Dh, rate = 3, 2, 32, 16, 0.1
    q, k, v, kv, g = _attn_inputs(5, G, H, P, Dh)
    scale = Dh ** -0.5
    keep = attention.philox_keep_mask(2024, G, H, P, rate)
    want = _jax_drop_bwd(*map(jnp.asarray, (q, k, v, kv, g)),
                         jnp.asarray(keep.numpy()), scale, rate)
    qt, kt, vt = (T(a).requires_grad_() for a in (q, k, v))
    out = attention.patch_attention_dropout_plain(qt, kt, vt, T(kv), scale,
                                                  rate, keep)
    out.backward(T(g))
    _close(out, want[0], "out")
    bwd = attention.patch_attention_dropout_vjp_plain(
        T(q), T(k), T(v), T(kv), scale, rate, keep, T(g))
    for got, auto, w, name in zip(bwd, (qt.grad, kt.grad, vt.grad),
                                  want[1:], "qkv"):
        _close(got, w, f"d{name}")
        _close(auto, w, f"autograd d{name}")
    # the wrapper's CPU path draws the same mask from the seed
    wrapped = attention.patch_attention_dropout(T(q), T(k), T(v), T(kv),
                                                scale, rate, 2024)
    _close(wrapped, want[0], "wrapper")


def test_philox_known_answers_and_keep_rate():
    """philox_keep_mask's generator is Philox4x32-10 (Random123's known
    answers), and its keep fraction at rate 0.1 over 2^20 draws is within
    5 binomial standard deviations of 0.9."""
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((0xffffffff,) * 4, (0xffffffff,) * 2,
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        got = attention.philox4x32_10(
            *(torch.tensor([c], dtype=torch.int64) for c in ctr),
            *(torch.tensor([c], dtype=torch.int64) for c in key))
        assert [int(t) for t in got] == list(want)
    keep = attention.philox_keep_mask(7, 32, 2, 128, 0.1)
    n = keep.numel()
    assert abs(float(keep.float().mean()) - 0.9) < 5 * (0.09 / n) ** 0.5
    assert attention.philox_keep_mask(7, 2, 2, 16, 0.0).all()


# ------------------------------------------------------ targets and loss ---

ACT = {"pos_bins": 5, "pos_bin_size": 0.01, "pos_heatmap_type": "dist",
       "pos_pred_type": "heatmap_disc", "rot_pred_type": "euler_disc",
       "euler_resolution": 5}


def _loss_inputs(seed=6, B=3, N=40, nb=10, bins=72):
    rng = np.random.RandomState(seed)
    counts = np.array([N, N - 9, N - 20][:B])
    mask = np.arange(N)[None] < counts[:, None]
    xyz = (rng.randn(B, N, 3) * 0.05).astype(np.float32)
    gt = np.zeros((B, 7), np.float32)
    gt[:, :3] = xyz[:, 4] + 0.003
    gt[2, :3] = 5.0                       # no support: nearest candidate
    gt[:, 3:6] = rng.randint(0, bins, (B, 3))
    gt[:, 6] = [0, 1, 1]
    robot = (rng.rand(B, N) < 0.2) & mask
    sort0 = np.stack([rng.permutation(N) for _ in range(B)])
    preds = {"pos": rng.randn(B, 3, N, nb).astype(np.float32),
             "rot": rng.randn(B, bins, 3).astype(np.float32),
             "open": rng.randn(B).astype(np.float32),
             "final_coord": np.take_along_axis(xyz, sort0[..., None], 1),
             "final_mask": np.take_along_axis(mask, sort0, 1),
             "sort0": sort0, "pool_overflow": np.int32(3)}
    preds["pos"] = np.where(preds["final_mask"][:, None, :, None],
                            preds["pos"], -1e9).astype(np.float32)
    batch = {"pc_fts": np.concatenate([xyz, np.zeros_like(xyz)], -1),
             "pc_mask": mask, "gt_actions": gt, "pc_robot_mask": robot,
             "batch_valid": np.array([True, True, False][:B])}
    return preds, batch


def test_disc_pos_targets_match_jax():
    """Device targets in the sorted frame (fp32, 1e-4 scaled), and the host
    twin of one cloud."""
    preds, batch = _loss_inputs()
    tp = {k: T(v) for k, v in preds.items()}
    tb = {k: T(v) for k, v in batch.items()}
    jp = {k: jnp.asarray(v) for k, v in preds.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    gt = batch["gt_actions"][:, :3]
    _close(build_disc_pos_targets(tb, T(gt), 5, ACT, tp),
           jtargets(jb, jnp.asarray(gt), 5, ACT, preds=jp))
    xyz = batch["pc_fts"][1, :31, :3]
    robot_idx = np.where(batch["pc_robot_mask"][1, :31])[0]
    for kind in ("plain", "dist"):
        _close(disc_pos_gt_prob_np(xyz, gt[1], 0.01, 5, kind, robot_idx),
               jprob_np(xyz, gt[1], 0.01, 5, kind, robot_idx))
        got = disc_pos_gt_prob(T(xyz[None]), torch.ones(1, 31, dtype=bool),
                               T(gt[1:2]), heatmap_type=kind, pos_bins=5)
        want = disc_pos_gt_prob_jnp(jnp.asarray(xyz), jnp.ones(31, bool),
                                    jnp.asarray(gt[1]), heatmap_type=kind,
                                    pos_bins=5)
        _close(got[0], want)


def test_compute_loss_matches_jax():
    """Loss dict and the gradients with respect to the head outputs."""
    preds, batch = _loss_inputs()
    tp = {k: T(v) for k, v in preds.items()}
    for k in ("pos", "rot", "open"):
        tp[k].requires_grad_()
    got = compute_loss(tp, {k: T(v) for k, v in batch.items()}, ACT,
                       {"pos_weight": 1.0, "rot_weight": 0.5})
    got["total"].backward()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(pos, rot, opn):
        jp = {k: jnp.asarray(v) for k, v in preds.items()}
        jp.update(pos=pos, rot=rot, open=opn)
        return jloss(jp, jb, ACT, {"pos_weight": 1.0, "rot_weight": 0.5})
    want = f(*(jnp.asarray(preds[k]) for k in ("pos", "rot", "open")))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)
    grads = jax.grad(lambda *a: f(*a)["total"], argnums=(0, 1, 2))(
        *(jnp.asarray(preds[k]) for k in ("pos", "rot", "open")))
    for k, w in zip(("pos", "rot", "open"), grads):
        _close(tp[k].grad, w, f"d{k}")


# ----------------------------------------------------------- optimizer ----

TRAIN_CFG = {"optim": "adamw", "learning_rate": 1e-2, "betas": [0.9, 0.98],
             "weight_decay": 0.05, "grad_norm": 1.0, "lr_sched": "cosine",
             "warmup_steps": 2, "num_train_steps": 10,
             "lr_multi": {"head": 0.5}}


class _Tiny(torch.nn.Module):
    def __init__(self, rng):
        super().__init__()
        self.head = torch.nn.Linear(6, 4)
        self.norm = torch.nn.LayerNorm(4)
        self.conv = torch.nn.Parameter(T(rng.randn(27, 3, 5)
                                         .astype(np.float32)))
        with torch.no_grad():
            self.head.weight.copy_(T(rng.randn(4, 6).astype(np.float32)))
            self.head.bias.copy_(T(rng.randn(4).astype(np.float32)))
            self.norm.weight.copy_(T(rng.randn(4).astype(np.float32)))


def _flax_tree(m):
    # a copy: jnp.asarray may alias the numpy view of a torch parameter
    # that the port's optimizer updates in place
    f = lambda t: jnp.array(t.detach().numpy(), copy=True)  # noqa: E731
    return {"head": {"kernel": f(m.head.weight).T, "bias": f(m.head.bias)},
            "norm": {"scale": f(m.norm.weight), "bias": f(m.norm.bias)},
            "conv": {"weight": f(m.conv)}}


def test_adamw_three_steps_match_jax():
    """Three clipped AdamW updates (global norm 1 against gradients of norm
    ~10, warmup then cosine, weight decay off for the bias and norm leaves,
    lr_multi 0.5 on the head) against the JAX flat_adamw."""
    rng = np.random.RandomState(7)
    m = _Tiny(rng)
    params = _flax_tree(m)
    tx, _ = jbuild_optimizer(params, TRAIN_CFG)
    state = tx.init(params)
    opt, schedule = build_optimizer(m, TRAIN_CFG)
    for _ in range(3):
        grads = {n: rng.randn(*p.shape).astype(np.float32) * 3
                 for n, p in m.named_parameters()}
        for n, p in m.named_parameters():
            p.grad = T(grads[n])
        opt.step()
        jg = {"head": {"kernel": jnp.asarray(grads["head.weight"]).T,
                       "bias": jnp.asarray(grads["head.bias"])},
              "norm": {"scale": jnp.asarray(grads["norm.weight"]),
                       "bias": jnp.asarray(grads["norm.bias"])},
              "conv": {"weight": jnp.asarray(grads["conv"])}}
        updates, state = tx.update(jg, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    want = _flax_tree(m)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        got = want
        for p in path:
            got = got[p.key]
        _close(np.asarray(got), leaf, str(path))
    assert isinstance(opt, FlatAdamW)


@pytest.mark.parametrize("sched", ["cosine", "linear", "inverse_sqrt",
                                   "cosine_cycle"])
def test_lr_decay_rate_matches_jax(sched):
    for step in (0, 1, 3, 50, 499, 500, 900, 1000, 1200):
        want = float(jdecay(step, sched, 500, 1000, num_cosine_cycles=2))
        assert abs(lr_decay_rate(step, sched, 500, 1000,
                                 num_cosine_cycles=2) - want) <= 1e-6


# -------------------------------------------------------------- data ------

DS_CFG = {"num_points": 1024, "pos_bins": 15, "pos_type": "disc",
          "augment_pc": True, "rm_robot": "box_keep_gripper"}


def test_keystep_dataset_and_collate_bit_equal_to_jax():
    """Samples of two synthetic_reach episodes (crop, robot boxes,
    subsample, augmentation, centring, euler bins, robot mask) and their
    collated batch, for one seed."""
    port = KeystepDataset(open_store("synthetic_reach"),
                          rng=np.random.RandomState(11), **DS_CFG)
    ref = JaxKeystepDataset(jopen_store("synthetic_reach"),
                            rng=np.random.RandomState(11), **DS_CFG)
    assert port.data_ids == ref.data_ids
    got, want = port[0] + port[5], ref[0] + ref[5]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)
    gb = collate_keystep_samples(got, 1024, num_clouds=8)
    wb = jcollate(want, 1024, num_clouds=8)
    assert set(gb) == set(wb)
    for k in wb:
        np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
