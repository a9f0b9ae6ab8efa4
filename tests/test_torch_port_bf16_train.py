"""PyTorch port vs the JAX package: the backward kernels' plain versions at
ptv3_config compute_dtype bfloat16, and training at bf16 on the CPU.

The plain versions are the CPU path of the wrappers and the oracles the
CUDA kernels are held against on the card (test_torch_port_gpu.py,
chip_smoke.py). At a small size, from numpy seeds, jitted with XLA's
excess precision off (tests/test_torch_port_bf16.py says why):
  * the conv's backward at bf16 (dx: the fp32 owner sums through the
    mirrored conv, rounded once; dW: K7's fp32 sums rounded once; dbias
    the fp32 sum of the cotangent) against jax.vjp of the Pallas windowed
    conv (pallas_conv.py `_windowed_op_bwd`, interpret mode) at bf16,
    within the one-rounding bar of ops/bf16.py (one bf16 ulp of the value
    plus 1e-4 of the scale), on a duplicate-free cloud (the Pallas dx is
    exact only there); against the XLA conv's VJP (ops/sparse_conv.py),
    which rounds each tap's dx product to bf16 and adds the taps in a bf16
    carry, within the wider XLA_DX_BAR, stated below; the Concat stem's
    125 taps x 263 channels against the XLA streaming conv's VJP (no
    Pallas path there); the policy stem's dW (K7 at 125 taps, Cin 7)
    against the XLA stencil product's VJP, and its dx (one matmul, then
    K10's plain version: fp32 sums rounded once) against the XLA VJP
    within XLA_DX_BAR (the windowed Pallas VJP's one rounding is held in
    test_torch_port_stem_vjp.py);
  * K4's backward at bf16 (K8: fp32 sums, one rounding) against jax.vjp of
    permute_rows in interpret mode (pallas_gather.py `_permute_op_bwd`),
    within the one-rounding bar, with rows colliding as the duplicate
    padding makes them;
  * K5 / K6 at bf16: the Pallas dropout kernels cannot run on the CPU
    even in interpret mode (their PRNG has no CPU lowering), so K5's and
    K6's plain versions are held to the XLA attention at bf16
    (pallas_attention `_xla_reference`, models/layers.py's formulas) and
    its jax.vjp at rate 0, and at rate 0.1 to the same formulas written
    here with the port's keep mask injected (flax Dropout's
    where(keep, a / (1 - rate), 0) before the cast to bf16): the output
    within the bar plus one bf16 ulp of each probability's share, the
    gradients within ATTN_GRAD_BAR (stated below: XLA rounds the
    probabilities' cotangent and q * scale's to bf16 where K6 keeps
    fp32);
  * the Trainer, train_simple_policy.main and train_motion_planner.main
    at bf16 on the CPU: finite losses, a bf16 backbone, fp32 gradients on
    the fp32 parameters, and a saved model file of fp32 tensors that
    loads strictly at fp32 and serves at bf16.
"""
import glob
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robot3dlotus_tpu.ops import pallas_attention as jattn
from robot3dlotus_tpu.ops import pallas_gather as jgather
from robot3dlotus_tpu.ops.pallas_conv import (build_window_map,
                                              subm_conv_windowed)
from robot3dlotus_tpu.ops.sparse_conv import (build_neighbor_map as
                                              jneighbor_map, subm_conv_apply)
from robot3dlotus_tpu_torch.eval.actioner import Actioner
from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.ops import attention, conv, gather, stem
from robot3dlotus_tpu_torch.ops.bf16 import bf16_excess
from robot3dlotus_tpu_torch.train import (checkpoint as ckpt,
                                          train_motion_planner,
                                          train_simple_policy)
from robot3dlotus_tpu_torch.train.serialization import load
from test_torch_port_mp_train import _tiny_release_argv
from test_torch_port_train_step import _tiny_release_config

BF16 = torch.bfloat16
NO_EXCESS = {"xla_allow_excess_precision": False}
# the XLA conv's dx rounds each of up to K tap products to bf16 and adds
# them in a bf16 carry: up to 2 K roundings of half an ulp of the running
# sum each, K = 27 (2^-9 * 54 ~ 0.1 of the largest value at worst; random
# rounding errors add far less): held within 2^-4 of max|ref|
XLA_DX_BAR = 2.0 ** -4
# K6 keeps the probabilities' cotangent and q * scale's in fp32 where the
# XLA VJP rounds them to bf16 (and multiplies by scale in bf16): each
# gradient element sums P terms, each off by up to a bf16 ulp of itself,
# plus one more rounding: held within 2^-5 of max|ref|
ATTN_GRAD_BAR = 2.0 ** -5


def T(a):
    return torch.from_numpy(np.array(a))


def jbf(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def tbf(a):
    return T(np.asarray(a, np.float32)).to(BF16)


def f32(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def jrun(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)(
        *args)


def within_bar(got, want, extra=None, what=""):
    """got within the bar of ops/bf16.py of want, the slack of max|want|
    itself (gradients are held to their own scale)."""
    w = torch.from_numpy(f32(want))
    excess = bf16_excess(got, w, extra=extra, relative=True)
    assert excess <= 0.0, (what, excess,
                           float((got.float() - w).abs().max()))


def within(got, want, bar, what=""):
    """|got - want| <= bar * max|want| (gradients are held to their own
    scale)."""
    g, w = f32(got), f32(want)
    err = np.abs(g - w).max()
    assert err <= bar * np.abs(w).max(), (what, err, np.abs(w).max())
    return err / np.abs(w).max()


def _unique_cloud(rng, B=2, N=96, span=12):
    gcs = [np.stack(np.unravel_index(rng.choice(span ** 3, N, replace=False),
                                     (span,) * 3), -1) for _ in range(B)]
    gc = np.asarray(gcs, np.int32)
    mask = np.arange(N)[None] < np.array([N, N - 13][:B])[:, None]
    return gc, mask


def _port_conv_grads(x, nm, w, b, g):
    """(dx, dW, dbias) of the port's conv at bf16: x and W bf16 leaves, the
    bias fp32, the cotangent g bf16."""
    xt, wt = tbf(x).requires_grad_(), tbf(w).requires_grad_()
    bt = None if b is None else T(b).requires_grad_()
    out = conv.subm_conv(xt, T(nm.idx), T(nm.ok), wt, bt) if w.shape[0] == 27 \
        or x.shape[-1] > stem.MAX_CIN else \
        stem.stem_conv(xt, T(nm.idx), T(nm.ok), wt)
    assert out.dtype == BF16
    out.backward(tbf(g))
    assert xt.grad is None or xt.grad.dtype == BF16
    assert wt.grad.dtype == BF16
    return xt.grad, wt.grad, None if bt is None else bt.grad


def _jax_conv_grads(fn, x, w, b, g):
    """jax.vjp at bf16 of fn(x, w, b) -> (dx, dW, dbias)."""
    args = (jbf(x), jbf(w)) + (() if b is None else (jnp.asarray(b),))

    def run(*a):
        out, vjp = jax.vjp(lambda *t: fn(*t).astype(jnp.bfloat16), *a)
        return vjp(jbf(g))
    return jrun(run, *args)


@pytest.mark.parametrize("cin,cout", [(32, 48), (64, 64)])
def test_conv_backward_bf16_matches_pallas_vjp(cin, cout):
    """The CPE conv's backward at bf16 against the Pallas VJP (one rounding
    each: the bar of ops/bf16.py) and against the XLA VJP (XLA_DX_BAR for
    dx; dW and dbias within the bar too: the XLA conv's weight gradient
    sums each tap in fp32 and rounds once)."""
    rng = np.random.RandomState(cin + cout)
    gc, mask = _unique_cloud(rng)
    wmap = build_window_map(jnp.asarray(gc), jnp.asarray(mask), 3, 4,
                            halo=64)
    assert int(jnp.max(wmap.far_dropped)) == 0
    x = (rng.randn(2, 96, cin) * mask[..., None]).astype(np.float32)
    w = (rng.randn(27, cin, cout) * cin ** -0.5).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    g = (rng.randn(2, 96, cout) * mask[..., None]).astype(np.float32)
    got = _port_conv_grads(x, wmap.nmap, w, b, g)
    pallas = _jax_conv_grads(lambda f, ww, bb: subm_conv_windowed(
        f, wmap, ww, bb, interpret=True), x, w, b, g)
    xla = _jax_conv_grads(lambda f, ww, bb: subm_conv_apply(
        f, wmap.nmap, ww, bb), x, w, b, g)
    for a, p, name in zip(got, pallas, ("dx", "dW", "dbias")):
        within_bar(a, p, what=f"{name} vs Pallas")
    gap = within(got[0], xla[0], XLA_DX_BAR, "dx vs XLA")
    within_bar(got[1], xla[1], what="dW vs XLA")
    within_bar(got[2], xla[2], what="dbias vs XLA")
    print(f"dx vs the XLA VJP: {gap:.3g} of max|ref|")


def test_conv_backward_bf16_on_duplicate_voxels():
    """A cloud with duplicate voxels (the owner sums add several bf16
    cotangents in fp32): dx against the XLA VJP (exact for any map) within
    XLA_DX_BAR, and the port's rounding of its fp32 sums against the same
    computation in fp32 rounded once (the one-rounding bar), so that the
    owner sum adds no rounding of its own."""
    rng = np.random.RandomState(5)
    gc, mask = _unique_cloud(rng)
    gc[:, 60:75] = gc[:, 10:25]
    nm = jneighbor_map(jnp.asarray(gc), jnp.asarray(mask), 3, 4, extent=16)
    x = (rng.randn(2, 96, 32) * mask[..., None]).astype(np.float32)
    w = (rng.randn(27, 32, 32) * 32 ** -0.5).astype(np.float32)
    g = (rng.randn(2, 96, 32) * mask[..., None]).astype(np.float32)
    dx, _, _ = _port_conv_grads(x, nm, w, np.zeros(32, np.float32), g)
    xla = _jax_conv_grads(lambda f, ww, bb: subm_conv_apply(f, nm, ww, bb),
                          x, w, np.zeros(32, np.float32), g)
    within(dx, xla[0], XLA_DX_BAR, "dx vs XLA")
    xr = tbf(x).float().requires_grad_()
    conv.subm_conv_plain(xr, T(nm.idx), T(nm.ok), tbf(w).float()).backward(
        tbf(g).float())
    within_bar(dx, xr.grad.to(BF16), what="dx vs the fp32 adjoint")


@pytest.mark.parametrize("cin", [263, 7])
def test_stem_backward_bf16_matches_xla(cin):
    """The k = 5 stems at bf16: the Concat stem (K2 and its mirrored dx,
    K7 at 125 taps x 263 channels) and the policy stem (K3, whose dW is K7
    at 125 taps x 7 channels; its dx G = g W^T then K10) against the XLA
    conv's VJP: dW within the one-rounding bar, dx within XLA_DX_BAR."""
    rng = np.random.RandomState(cin)
    gc, mask = _unique_cloud(rng, N=64, span=8)
    nm = jneighbor_map(jnp.asarray(gc), jnp.asarray(mask), 5, 3, extent=8)
    x = (rng.randn(2, 64, cin) * mask[..., None]).astype(np.float32)
    w = (rng.randn(125, cin, 32) * (125 * cin) ** -0.5).astype(np.float32)
    g = (rng.randn(2, 64, 32) * mask[..., None]).astype(np.float32)
    xla = _jax_conv_grads(lambda f, ww: subm_conv_apply(f, nm, ww),
                          x, w, None, g)
    dx, dw, _ = _port_conv_grads(x, nm, w, None, g)
    what = "wide stem" if cin > stem.MAX_CIN else "policy stem"
    within_bar(dw, xla[1], what=f"{what} dW")
    gap = within(dx, xla[0], XLA_DX_BAR, f"{what} dx")
    print(f"{what} dx vs the XLA VJP: {gap:.3g} of max|ref|")


@pytest.mark.parametrize("D", [8, 64])
def test_gather_backward_bf16_matches_pallas_vjp(D):
    """K8 at bf16 (the backward of gather_rows) against jax.vjp of
    permute_rows in interpret mode at bf16, 96 of 128 rows landing on 4
    source rows: the one-rounding bar; the fp32 sums (the conv's owner
    sum) against the fp32 sum of the widened rows."""
    rng = np.random.RandomState(D)
    x = rng.randn(2, 40, D).astype(np.float32)
    idx = rng.randint(0, 40, (2, 128)).astype(np.int32)
    idx[:, 32:] = rng.randint(0, 4, (2, 96))
    g = rng.randn(2, 128, D).astype(np.float32)
    xt = tbf(x).requires_grad_()
    gather.gather_rows(xt, T(idx)).backward(tbf(g))
    assert xt.grad.dtype == BF16
    want = jrun(lambda a, gg: jax.vjp(lambda t: jgather.permute_rows(
        t, jnp.asarray(idx), impl="pallas_interpret"), a)[1](gg)[0],
        jbf(x), jbf(g))
    within_bar(xt.grad, want, what="K8 vs Pallas")
    sums = gather.scatter_rows_add(tbf(g), T(idx), 40, torch.float32)
    assert sums.dtype == torch.float32
    np.testing.assert_allclose(
        sums.numpy(), gather.scatter_rows_add_plain(
            tbf(g).float(), T(idx), 40).numpy(), rtol=0, atol=1e-6)


def _xla_dropout_attention(q, k, v, kv, scale, rate, keep):
    """models/layers.py's XLA attention with flax Dropout's formula and an
    injected keep mask, at q's dtype."""
    logits = jnp.einsum("ghpd,ghqd->ghpq", (q * scale).astype(jnp.float32),
                        k.astype(jnp.float32))
    logits = jnp.where(kv[:, None, None, :], logits, -1e9)
    a = jax.nn.softmax(logits, axis=-1)
    if rate > 0.0:
        a = jnp.where(keep, a / (1.0 - rate), 0.0)
    return jnp.einsum("ghpq,ghqd->ghpd", a.astype(v.dtype), v,
                      preferred_element_type=jnp.float32).astype(q.dtype)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("G,H,P,Dh", [(3, 2, 128, 32), (4, 2, 37, 24)])
def test_attention_dropout_bf16_matches_xla(G, H, P, Dh, rate):
    """K5's plain version at bf16 (out, lse, bits) and K6's on its outputs
    against the XLA attention at bf16 and its VJP (at rate 0.1 with the
    port's Philox keep mask injected): out within the bar plus the
    dropped probabilities' allowance; dq, dk, dv within ATTN_GRAD_BAR; at
    rate 0 the XLA path is pallas_attention `_xla_reference` itself."""
    rng = np.random.RandomState(G * P + Dh)
    q, k, v, gout = (rng.randn(G, H, P, Dh).astype(np.float32)
                     for _ in range(4))
    kv = rng.rand(G, P) > 0.2
    scale, seed = Dh ** -0.5, 1234
    targs = (tbf(q), tbf(k), tbf(v), T(kv), scale)
    out, lse, bits = attention.patch_attention_dropout_fwd(*targs, rate,
                                                           seed)
    assert out.dtype == BF16 and lse.dtype == torch.float32
    keep = attention.philox_keep_mask(seed, G, H, P, rate)
    assert torch.equal(bits, attention.pack_keep_bits(keep))
    grads = attention.patch_attention_dropout_bwd(
        *targs[:4], out, lse, bits, tbf(gout), scale, rate)
    jargs = (jbf(q), jbf(k), jbf(v))
    jkv, jkeep = jnp.asarray(kv), jnp.asarray(keep.numpy())

    def fwd(a, b, c):
        if rate == 0.0:
            return jattn._xla_reference(a, b, c, jkv, scale)
        return _xla_dropout_attention(a, b, c, jkv, scale, rate, jkeep)

    def run(a, b, c, gg):
        o, vjp = jax.vjp(fwd, a, b, c)
        return o, vjp(gg)
    want, jgrads = jrun(run, *jargs, jbf(gout))
    within_bar(out, want, attention.bf16_probability_allowance(
        *targs, rate, keep), "K5 out")
    gaps = [within(a, b, ATTN_GRAD_BAR, f"K6 d{n}")
            for a, b, n in zip(grads, jgrads, "qkv")]
    assert all(t.dtype == BF16 for t in grads)
    print(f"K6 vs the XLA VJP at rate {rate}: {gaps} of max|ref|")
    # the autograd Function: K5 forward, K6 backward, the same values
    qr, kr, vr = (t.clone().requires_grad_() for t in targs[:3])
    attention.patch_attention_dropout(qr, kr, vr, T(kv), scale, rate,
                                      seed).backward(tbf(gout))
    for a, b in zip((qr.grad, kr.grad, vr.grad), grads):
        assert torch.equal(a, b)


# ------------------------------------------------ training at bf16 --------

def _bf16_opts():
    return ["MODEL.ptv3_config.compute_dtype", "bfloat16"]


def _check_run(trainer, run_dir, caplog):
    assert trainer.model.ptv3_model.compute_dtype == BF16
    assert all(p.dtype == torch.float32 and p.grad is not None and
               p.grad.dtype == torch.float32
               for p in trainer.model.parameters() if p.requires_grad)
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("step ")]
    assert lines
    for line in lines:
        for kv in line.split(": ", 1)[1].split(", "):
            assert np.isfinite(float(kv.split("=")[1])), line
    files = sorted(glob.glob(os.path.join(run_dir, "ckpts",
                                          "model_step_*.msgpack")))
    assert files
    leaves = jax.tree_util.tree_leaves(load(files[-1]))
    assert leaves and all(np.asarray(a).dtype in (np.float32, np.int32,
                                                  np.int64)
                          for a in leaves)
    assert any(np.asarray(a).dtype == np.float32 for a in leaves)
    return files[-1]


def test_policy_main_trains_at_bf16_and_serves(caplog, tmp_path):
    """train_simple_policy.main at bf16 (the CLI override) on the CPU: 3
    steps with the release dropout rates, finite logged losses, fp32
    gradients on the fp32 parameters, an fp32 model file that an fp32 and
    a bf16 Actioner load strictly and serve."""
    config = _tiny_release_config(num_train_steps=3, log_steps=1,
                                  save_steps=3)
    config.defrost()
    config.merge_from_list(_bf16_opts())
    config.output_dir = str(tmp_path)
    config.freeze()
    with caplog.at_level("INFO", logger="robot3dlotus_tpu_torch.train"):
        trainer = train_simple_policy.main(config, device="cpu")
    assert trainer.optimizer.count == 3
    path = _check_run(trainer, str(tmp_path), caplog)
    cfg_file = os.path.join(str(tmp_path), "logs", "training_config.yaml")
    for opts, dt in (([], None), (_bf16_opts(), BF16)):
        a = Actioner(cfg_file, checkpoint=path, device="cpu",
                     cli_opts=["MODEL.ptv3_config.compute_dtype",
                               "float32"] + opts)
        assert a.model.ptv3_model.compute_dtype == dt
        for k, v in trainer.model.state_dict().items():
            assert torch.equal(a.model.state_dict()[k], v), k


def test_motion_planner_main_trains_at_bf16(caplog, tmp_path):
    """train_motion_planner.main --device cpu with the bf16 override: 3
    steps, finite logged losses, an fp32 model file that loads strictly
    into an fp32 model."""
    config, device = train_motion_planner.build_args(
        _tiny_release_argv("--device", "cpu") + _bf16_opts() +
        ["output_dir", str(tmp_path), "TRAIN.save_steps", "3"])
    with caplog.at_level("INFO", logger="robot3dlotus_tpu_torch.train"):
        trainer = train_motion_planner.main(config, device=device)
    assert trainer.optimizer.count == 3
    path = _check_run(trainer, str(tmp_path), caplog)
    cfg = config.clone()
    cfg.defrost()
    cfg.MODEL.ptv3_config.compute_dtype = None
    model = build_model(cfg.MODEL, device="cpu")
    model.load_state_dict(ckpt.load_any_model_ckpt(path, model), strict=True)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
