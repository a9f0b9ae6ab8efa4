"""PyTorch port vs the JAX package: the backbone's attention options.

ptv3_config enable_rpe, scaled_cosine_attn, add_coords_in_attn ('qkv' /
'qk') and upcast_attention (all off in the release configs) against the
JAX package's XLA attention (attn_impl 'xla', the path its Pallas kernel
leaves for the bias and the per-head scale), on the CPU at small sizes from
numpy seeds:
  * the plain rpe_bias bit-equal to the JAX one, and the position bound
    of the JAX expression (15 at P = 128, 7 at 16, 6 at 8);
  * SerializedAttention with each option alone and with rpe + cosine +
    'qkv', at P = 16, with an SFC order gathered (the coordinates go
    through the order as the features do) and at P = 128 (b = 15): the
    fp32 output within 1e-4 * max(1, |ref|); the gradients of the input
    and of every parameter (qkv, the norms, proj, coords_proj, logit_scale,
    rpe_table) against jax.vjp at attention dropout 0, each within 1e-4 of
    its own largest |grad|, floored at 1e-3 of the largest of all (the k
    norm's bias has a zero gradient up to rounding); the table's rows sum
    ds over up to B P^2 pairs, in another order, and the same bar holds;
  * at bf16, rpe + cosine + 'qk' with and without upcast_attention, and
    upcast_attention with rpe alone and with cosine alone, against the JAX
    program (its XLA path, the one JAX runs with either option) jitted with
    XLA's excess precision off: the attention's output within the
    ops/bf16.py bar plus one bf16 ulp of each probability's share (the
    port rounds each probability where JAX does, also under upcast: fp32
    logits from fp32 q and k, the probabilities rounded to v's bf16); after
    the output projection, a chain of roundings, within the chain bar of
    test_torch_port_bf16.py (2^-6 of the scale, at most 2% of the elements
    off);
  * upcast_attention at bf16 without those two options against the JAX
    Pallas path (attn_impl 'pallas_interpret', the kernel interpreted on
    the CPU): q and k cast back to bf16 after the fp32 norms, so the port
    calls its bf16 attention (the bf16 K1 on the card), within the same
    bars;
  * a Python mirror of K6's shared memory with the options
    (csrc/attention_dropout.cuh): two blocks an SM at every head dim and
    position bound, both dtypes;
  * the plain K5 / K6 with the bias and the scale at rate 0.1 against
    autograd of the plain forward under the same Philox mask (fp32, 1e-4
    of each gradient's scale: dhead_scale sums ds S over a patch, where
    the sum over each row's keys of ds is 0, so it cancels), and the
    autograd Function on the CPU bit-equal to the plain versions;
  * a SimplePolicyPTV3CA forward and one whole training step with rpe +
    cosine + 'qkv' (stage 1 at capacity 64 under a patch of 128, so its
    patch and bound are min(patch, capacity)'s: 64 and 12) against the JAX
    forward and make_train_step, every gradient and updated parameter held
    (rpe_table and logit_scale above the gradient floor; coords_proj's
    gradients are below it here, held to it, and to their own scale in the
    SerializedAttention cases); the weights cross by params_from_jax,
    strictly;
  * a MotionPlannerPTV3CA forward with the same options (it shares the
    backbone);
  * ptv3_kwargs passes the four options through.
The CUDA kernels with the options against these plain versions:
test_torch_port_gpu.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robot3dlotus_tpu.models import layers as jl
from robot3dlotus_tpu.models.motion_planner import MotionPlannerTPU
from robot3dlotus_tpu.models.simple_policy import compute_loss as jloss
from robot3dlotus_tpu_torch.convert import params_from_jax, params_to_jax
from robot3dlotus_tpu_torch.models import layers as tl
from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.models.simple_policy import (compute_loss,
                                                         ptv3_kwargs)
from robot3dlotus_tpu_torch.ops import attention
from robot3dlotus_tpu_torch.ops.bf16 import bf16_excess
import test_torch_port_motion_planner as tmp
from test_torch_port_bf16 import NO_EXCESS, f32, jrun
from test_torch_port_train_step import LOSS, PTV3
from test_torch_port_variants import (carried, check_policy,
                                      check_train_step, close, model_cfg,
                                      jax_policy, perturb_port,
                                      policy_batch)
from torch_port_time_limit import time_limit  # noqa: F401

TIME_LIMIT_S = 120
ATOL = 1e-4
BF16 = torch.bfloat16
OPTS = {"enable_rpe": True, "scaled_cosine_attn": True,
        "add_coords_in_attn": "qkv"}


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("P", [8, 16, 64, 128])
def test_rpe_bias_bit_equal_jax(P):
    b = attention.pos_bound(P)
    assert b == int((4 * P) ** (1 / 3) * 2)
    assert {8: 6, 16: 7, 128: 15}.get(P, b) == b
    rng = np.random.RandomState(P)
    table = rng.randn(3 * (2 * b + 1), 4).astype(np.float32)
    rel = rng.randint(-3 * b, 3 * b + 1, (2, 5, 7, 3)).astype(np.int32)
    want = np.asarray(jl.rpe_bias(jnp.asarray(table), jnp.asarray(rel), b))
    got = tl.rpe_bias(T(table), T(rel), b).numpy()
    assert got.shape == (2, 5, 7, 4)
    np.testing.assert_array_equal(got, want)


def _aux(seed, B, N, P, shuffled):
    """Both packages' attention inputs for B clouds of N slots (counts N
    and N - P / 2 - 3: a ragged last patch and a duplicate-padded one):
    the key mask, grid coordinates spanning more than the bound (so the
    clip bites), coordinates, and the order of index 1 (shuffled: a
    random order gathered with its inverse; else None, the identity)."""
    from robot3dlotus_tpu.ops.patching import build_pad_maps as jpad
    from robot3dlotus_tpu_torch.ops.patching import build_pad_maps
    rng = np.random.RandomState(seed)
    counts = np.array([N, N - P // 2 - 3][:B], np.int32)
    gc = rng.randint(0, 40, (B, N, 3)).astype(np.int32)
    coord = rng.uniform(-0.3, 0.3, (B, N, 3)).astype(np.float32)
    sp, kv = build_pad_maps(T(counts), N, P)
    jsp, jkv = jpad(jnp.asarray(counts), N, P)
    order = inverse = None
    if shuffled:
        keys = rng.rand(B, N) + (np.arange(N)[None] >= counts[:, None])
        order = np.argsort(keys, -1, kind="stable").astype(np.int32)
        inverse = np.argsort(order, -1).astype(np.int32)
    orders = [None, None if order is None else T(order).long()]
    invs = [None, None if inverse is None else T(inverse).long()]
    taux = {"order": orders, "inverse": invs, "src_pos": sp,
            "key_valid": kv, "counts": T(counts).long(),
            "grid_coord": T(gc), "coord": T(coord)}
    jaux = dict(order=[None, None if order is None else jnp.asarray(order)],
                inverse=[None, None if inverse is None
                         else jnp.asarray(inverse)],
                src_pos=jsp, key_valid=jkv, counts=jnp.asarray(counts),
                grid_coord=jnp.asarray(gc), coord=jnp.asarray(coord))
    return taux, jaux


def _jax_attention(C, H, P, opts, dt=None):
    return jl.SerializedAttention(C, H, P, order_index=1, qk_norm=True,
                                  attn_impl="xla", dtype=dt, **opts)


def _jax_call(jm, variables, feat, jaux):
    return jm.apply(variables, feat, jaux["order"], jaux["inverse"],
                    jaux["src_pos"], jaux["key_valid"], deterministic=True,
                    grid_coord=jaux["grid_coord"], coord=jaux["coord"],
                    counts=jaux["counts"])


ATTN_CASES = {
    "rpe": (16, False, {"enable_rpe": True}),
    "cosine": (16, False, {"scaled_cosine_attn": True}),
    "coords_qkv": (16, True, {"add_coords_in_attn": "qkv"}),
    "coords_qk": (16, True, {"add_coords_in_attn": "qk"}),
    "upcast": (16, False, {"upcast_attention": True}),
    "all_shuffled": (16, True, OPTS),
    "rpe_cosine_p128": (128, False, {"enable_rpe": True,
                                     "scaled_cosine_attn": True}),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_serialized_attention_options_match_jax(case):
    P, shuffled, opts = ATTN_CASES[case]
    B, C, H = 2, 32, 2
    N = 2 * P if P < 128 else 256
    taux, jaux = _aux(7, B, N, P, shuffled)
    port = perturb_port(tl.SerializedAttention(
        C, H, P, torch.Generator().manual_seed(0), order_index=1, **opts))
    names = dict(port.named_parameters())
    for want in (["rpe_table"] if opts.get("enable_rpe") else []) + \
            (["logit_scale"] if opts.get("scaled_cosine_attn") else []) + \
            (["coords_proj.weight"] if opts.get("add_coords_in_attn")
             else []):
        assert want in names, (want, sorted(names))
    variables = {"params": params_to_jax(port)["params"]}
    if opts.get("enable_rpe"):
        b = attention.pos_bound(P)
        assert variables["params"]["rpe_table"].shape == (3 * (2 * b + 1), H)
    rng = np.random.RandomState(3)
    feat = rng.randn(B, N, C).astype(np.float32)
    g = rng.randn(B, N, C).astype(np.float32)
    jm = _jax_attention(C, H, P, opts)
    # the JAX init's tree is the port's
    shapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.asarray(feat), jaux["order"],
                                       jaux["inverse"], jaux["src_pos"],
                                       jaux["key_valid"],
                                       grid_coord=jaux["grid_coord"],
                                       coord=jaux["coord"],
                                       counts=jaux["counts"]))["params"])
    assert shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                            variables["params"])
    want, vjp = jax.vjp(lambda p, x: _jax_call(jm, {"params": p}, x, jaux),
                        variables["params"], jnp.asarray(feat))
    jgrads, jdx = vjp(jnp.asarray(g))

    port.train()                      # attention dropout 0: K5 / K6 plain
    x = T(feat).requires_grad_()
    got = port(x, taux)
    close(got, want, f"{case} forward")
    got.backward(T(g))
    grads = params_from_jax({"params": jgrads})
    grads["input"] = np.asarray(jdx)
    names["input"] = x
    assert set(grads) == set(names)
    scales = {k: float(np.abs(np.asarray(w)).max()) for k, w in
              grads.items()}
    # a leaf whose gradient is zero up to rounding (the k norm's bias
    # shifts every logit of a query alike) is held to the floor
    floor = 1e-3 * max(scales.values())
    for k in grads:
        if k.startswith(("rpe_table", "logit_scale", "coords_proj")):
            assert scales[k] >= floor, (k, scales[k], floor)
    for k, w in grads.items():
        np.testing.assert_allclose(
            names[k].grad.numpy(), np.asarray(w), rtol=0,
            atol=ATOL * max(scales[k], floor), err_msg=f"{case} grad {k}")
    port.eval()
    with torch.no_grad():
        close(port(T(feat), taux), want, f"{case} eval forward")


@pytest.mark.parametrize("upcast", [False, True])
def test_serialized_attention_options_bf16_match_jax(upcast):
    """rpe + cosine + 'qk' at bf16: the attention output (before the
    projection, read by a hook on proj's input) within the bf16 bar plus
    the probabilities' allowance, the module output within the chain bar
    of test_torch_port_bf16.py (2^-6 of the scale, at most 2% of the
    elements off); with upcast_attention the JAX XLA path's fp32 logits
    and bf16 probabilities."""
    _options_bf16_vs_jax({"enable_rpe": True, "scaled_cosine_attn": True,
                          "add_coords_in_attn": "qk",
                          "upcast_attention": upcast}, "xla")


@pytest.mark.parametrize("option", ["enable_rpe", "scaled_cosine_attn"])
def test_upcast_bf16_with_one_option_matches_jax_xla(option):
    """upcast_attention at bf16 with one option: the JAX XLA path (fp32
    logits from fp32 q and k, probabilities rounded to bf16 before P v):
    the port's attention call takes fp32 q and k and the bf16 v (the
    _opts kernels' mixed route on the card), within the bars above."""
    calls = _options_bf16_vs_jax({option: True, "upcast_attention": True},
                                 "xla")
    assert calls == [(torch.float32, torch.float32, BF16)]


def test_upcast_bf16_without_options_matches_jax_pallas():
    """upcast_attention at bf16 without rpe and cosine: the JAX Pallas path
    (attn_impl 'pallas_interpret'), q and k fp32 through the norms and
    cast back to bf16: the port's attention call takes bf16 q, k, v (the
    bf16 K1 on the card), within the bars above."""
    calls = _options_bf16_vs_jax({"upcast_attention": True},
                                 "pallas_interpret")
    assert calls == [(BF16, BF16, BF16)]


def _options_bf16_vs_jax(opts, impl):
    """SerializedAttention at bf16 with `opts` against the JAX module with
    attn_impl `impl`, jitted with excess precision off (the bars of
    test_serialized_attention_options_bf16_match_jax); returns the dtypes
    of q, k, v at the port's attention call."""
    P, B, C, H = 16, 2, 32, 2
    taux, jaux = _aux(11, B, 2 * P, P, False)
    port = perturb_port(tl.SerializedAttention(
        C, H, P, torch.Generator().manual_seed(0), order_index=1,
        dtype=BF16, **opts)).eval()
    variables = {"params": params_to_jax(port)["params"]}
    feat = np.random.RandomState(4).randn(B, 2 * P, C).astype(np.float32)
    jm = jl.SerializedAttention(C, H, P, order_index=1, qk_norm=True,
                                attn_impl=impl, dtype=jnp.bfloat16, **opts)
    want = jrun(lambda v, x: _jax_call(jm, v, x, jaux), variables,
                jnp.asarray(feat).astype(jnp.bfloat16))
    want_attn = _jax_attention_output(jm, variables, feat, jaux)
    seen = {}
    h = port.proj.register_forward_hook(
        lambda m, a, o: seen.update(attn=a[0]))
    with torch.inference_mode():
        got = port(T(feat).to(BF16), taux)
    h.remove()
    assert got.dtype == BF16 and seen["attn"].dtype == BF16
    allowance, calls = _prob_allowance(port, feat, taux)
    assert bf16_excess(seen["attn"], torch.from_numpy(f32(want_attn).copy()),
                       extra=allowance) <= 0
    d = np.abs(f32(got) - f32(want))
    assert d.max() <= 2.0 ** -6 * max(1.0, np.abs(f32(want)).max())
    assert (d > 0).mean() <= 0.02
    return calls


def _jax_attention_output(jm, variables, feat, jaux):
    """The JAX module's attention output before its projection: the
    module applied with proj's kernel the identity and its bias 0 (proj
    is a bf16 Dense: the identity's products and zero bias are exact)."""
    v = jax.tree_util.tree_map(np.asarray, variables)
    C = feat.shape[-1]
    v["params"]["proj"] = {"kernel": np.eye(C, dtype=np.float32),
                           "bias": np.zeros(C, np.float32)}
    return jrun(lambda vv, x: _jax_call(jm, vv, x, jaux), v,
                jnp.asarray(feat).astype(jnp.bfloat16))


def _prob_allowance(port, feat, taux):
    """2^-7 sum_j p_j |v_j| of the port's own attention call, laid out as
    the attention output (B, N, C): captured at the kernel's call; and
    the dtypes of the call's q, k, v."""
    calls, dtypes = [], []
    orig = tl.patch_attention

    def rec(q, k, v, kv, scale, hs=None, rpe=None):
        calls.append(attention.bf16_probability_allowance(
            q, k, v, kv, scale, head_scale=hs, rpe=rpe))
        dtypes.append((q.dtype, k.dtype, v.dtype))
        return orig(q, k, v, kv, scale, hs, rpe)
    tl.patch_attention = rec
    try:
        with torch.inference_mode():
            port(T(feat).to(BF16), taux)
    finally:
        tl.patch_attention = orig
    a = calls[0]                                  # (B NP, H, P, Dh)
    B, N, C = feat.shape
    P, H = a.shape[2], a.shape[1]
    return a.reshape(B, N // P, H, P, -1).permute(0, 1, 3, 2, 4).reshape(
        B, N, C), dtypes


def _opt_inputs(seed, G=3, H=2, P=16, Dh=8):
    rng = np.random.RandomState(seed)
    q, k, v, g = (T(rng.randn(G, H, P, Dh).astype(np.float32))
                  for _ in range(4))
    kv = T(rng.rand(G, P) > 0.2)
    kv[1] = False                                  # a patch with no key
    b = attention.pos_bound(P)
    gc = T(rng.randint(0, 3 * b, (G, P, 3)).astype(np.int32))
    table = T(rng.randn(3 * (2 * b + 1), H).astype(np.float32))
    hs = T(rng.uniform(5.0, 20.0, H).astype(np.float32))
    return q, k, v, kv, g, hs, (gc, table, b)


@pytest.mark.parametrize("which", ["both", "rpe", "scale"])
def test_k5_k6_plain_with_options_match_autograd(which):
    """K6's plain version (dq, dk, dv, dtable, dhead_scale from K5's saved
    outputs) against autograd of the plain forward under the same Philox
    mask at rate 0.1, and _PatchAttentionDropout on the CPU against both."""
    q, k, v, kv, g, hs, rpe = _opt_inputs(5)
    hs = hs if which != "rpe" else None
    rpe = rpe if which != "scale" else None
    scale, rate, seed = 0.3, 0.1, 1234
    G, H, P, _ = q.shape
    out, lse, bits = attention.patch_attention_dropout_fwd_plain(
        q, k, v, kv, scale, rate, seed, hs, rpe)
    keep = attention.philox_keep_mask(seed, G, H, P, rate)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    hs_l = None if hs is None else hs.clone().requires_grad_()
    tab_l = None if rpe is None else rpe[1].clone().requires_grad_()
    rpe_l = None if rpe is None else (rpe[0], tab_l, rpe[2])
    ref = attention.patch_attention_dropout_plain(*leaves, kv, scale, rate,
                                                  keep, hs_l, rpe_l)
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), atol=1e-6,
                               rtol=0)
    wrt = leaves + [t for t in (tab_l, hs_l) if t is not None]
    want = torch.autograd.grad(ref, wrt, g)
    got = attention.patch_attention_dropout_bwd_plain(
        q, k, v, kv, out, lse, bits, g, scale, rate, hs, rpe)
    got = [t for t in got if t is not None]
    fn_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    hs_f = None if hs is None else hs.clone().requires_grad_()
    tab_f = None if rpe is None else rpe[1].clone().requires_grad_()
    o = attention.patch_attention_dropout(
        *fn_leaves, kv, scale, rate, seed, hs_f,
        None if rpe is None else (rpe[0], tab_f, rpe[2]))
    np.testing.assert_array_equal(o.detach().numpy(), out.numpy())
    fn = torch.autograd.grad(o, fn_leaves + [t for t in (tab_f, hs_f)
                                             if t is not None], g)
    assert len(got) == len(want) == len(fn)
    for a, b_, c, name in zip(got, want, fn, ["dq", "dk", "dv", *(
            ["dtable"] if rpe is not None else []),
            *(["dhead_scale"] if hs is not None else [])]):
        tol = ATOL * float(b_.abs().max())
        assert float(b_.abs().max()) > 0, name
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=tol, rtol=0,
                                   err_msg=name)
        np.testing.assert_array_equal(c.numpy(), a.numpy(), err_msg=name)


def _options_cfg(cls="SimplePolicyPTV3CA"):
    """The tiny policy with rpe + cosine + 'qkv'; stage 1's capacity (64)
    below its patch (128)."""
    return model_cfg(cls, dict(OPTS, enc_patch_size=[16, 128],
                               stage_caps=[128, 64]))


def test_policy_forward_with_options_matches_jax():
    cfg = _options_cfg()
    port = check_policy(cfg, policy_batch(0))
    blocks = {n: m for n, m in port.ptv3_model.named_modules()
              if isinstance(m, tl.SerializedAttention)}
    assert {n: (m.patch_size, m.pos_bnd) for n, m in blocks.items()} == {
        "enc0_block0.attn": (16, 7), "enc1_block0.attn": (64, 12),
        "dec0_block0.attn": (16, 7)}


def test_policy_train_step_with_options_matches_jax(monkeypatch):
    cfg = _options_cfg()
    act = cfg["action_config"]
    check_train_step(
        cfg, jax_policy(cfg), lambda p, b: jloss(p, b, act, LOSS),
        lambda p, b: compute_loss(p, b, act, LOSS), policy_batch(seed=2),
        [[2, 0, 3, 1], [1, 3, 0, 2]], monkeypatch,
        must_learn=tuple(f"ptv3_model.{b}.attn.{p}"
                         for b in ("enc0_block0", "enc1_block0",
                                   "dec0_block0")
                         for p in ("rpe_table", "logit_scale")))


def test_motion_planner_forward_with_options_matches_jax():
    ptv3 = dict(tmp.PTV3, **OPTS)
    cfg = dict(tmp.MP_MODEL, ptv3_config=ptv3)
    jm = MotionPlannerTPU(ptv3_cfg=dict(ptv3, attn_impl="xla",
                                        conv_impl="xla"),
                          act_cfg=tmp.ACT, variant="ca")
    batch = tmp.mp_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    port, variables = carried(cfg, jm, jb)
    assert any(n.endswith("attn.rpe_table") for n in port.state_dict())
    want = jax.jit(lambda v, b: jm.apply(v, b, deterministic=True))(
        variables, jb)
    with torch.no_grad():
        got = port({k: T(v) for k, v in batch.items()})
    for k in ("pos", "rot", "open", "stop"):
        tmp._close_valid(got[k], want[k], k)


def test_ptv3_kwargs_passes_the_options():
    opts = dict(OPTS, upcast_attention=True, compute_dtype="bfloat16")
    assert ptv3_kwargs(opts) == opts
    with pytest.raises(ValueError, match="not implemented"):
        ptv3_kwargs({"no_such_option": True})
    with pytest.raises(ValueError, match="add_coords_in_attn"):
        build_model(dict(_options_cfg(), ptv3_config=dict(
            _options_cfg()["ptv3_config"], add_coords_in_attn="xyz")),
            device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_cosine_normalize_zero_row_has_zero_gradient(dtype):
    """A zero row (a dead slot whose input is zero, as at init) normalises
    to zero, and with no cotangent there (nothing reads a dead slot) its
    gradient is zero at both dtypes (the JAX package's root at 0 gives
    0 x inf = NaN there); every gradient is finite; the other rows are
    x / ||x||, the JAX package's value (at bf16 within the ops/bf16.py
    bar)."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(4, 8).astype(np.float32)).to(dtype)
    x[1] = 0
    g = torch.from_numpy(rng.randn(4, 8).astype(np.float32)).to(dtype)
    g[1] = 0
    xr = x.clone().requires_grad_()
    y = tl.cosine_normalize(xr)
    y.backward(g)
    assert torch.isfinite(xr.grad.float()).all()
    assert (xr.grad[1] == 0).all() and (y[1] == 0).all()
    want = np.asarray(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == BF16 else jnp.float32) / jnp.maximum(
        jnp.linalg.norm(jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if dtype == BF16 else jnp.float32), axis=-1,
            keepdims=True), 1e-12)).astype(np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(y.detach().numpy(), want, rtol=0,
                                   atol=1e-6)
    else:      # a norm's fp32 sum in another order may round apart
        assert bf16_excess(y.detach(), torch.from_numpy(want)) <= 0


# csrc/attention_dropout.cuh's K6 shared memory, in bytes: kMaxP = 128
# rows; Layout<Dh> (fp32: S = Dh + 4, DS = 132) and Layout16<Dh> (bf16: S =
# Dh, or Dh + 8 where Dh / 8 is even; ds rows of kDS16 = 136 floats);
# LogitOpts' kSmem (the int4 coordinates and the 96-float table column),
# 8 floats of dhs; the table pass's 31 rows of 128 floats
K6_MAX_P, K6_WORDS = 128, 4
K6_OPTS = K6_MAX_P * 16 + 96 * 4 + 8 * 4
K6_ROWS = 31 * K6_MAX_P * 4
# two blocks an SM: 228 KB of an H100 SM, 1 KB reserved a block, the
# 128-byte static key mask
K6_TWO_BLOCKS = (228 * 1024) // 2 - 1024 - K6_MAX_P


def _k6_smem(Dh, bf16, rpe, release=False):
    """K6's dynamic shared memory with the options (bwd_total_smem /
    bwd16_total_smem); rpe False: the head scale alone; release: no
    option (NoOpts)."""
    opts = 0 if release else K6_OPTS if rpe else 8 * 4
    if not bf16:
        S = Dh + 4
        own = (K6_MAX_P * 132 + 2 * K6_MAX_P * S + 2 * K6_MAX_P) * 4 + \
            K6_MAX_P * K6_WORDS * 4
        rows_in_q = 2 * K6_MAX_P * S * 4 >= K6_ROWS
        return own + opts + (K6_ROWS if rpe and not rows_in_q else 0)
    S = Dh if (Dh // 8) % 2 else Dh + 8
    slice_ = K6_MAX_P * S * 2
    own = K6_MAX_P * 136 * 4 + 4 * slice_ + 2 * K6_MAX_P * 4 + \
        K6_MAX_P * K6_WORDS * 4
    opts_in_v = slice_ >= opts
    # after phase 2: q, g, k's slices and v's less the options' data
    free = 3 * slice_ + (slice_ - opts if opts_in_v else slice_)
    return own + (0 if opts_in_v else opts) + \
        (K6_ROWS if rpe and free < K6_ROWS else 0)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("Dh", [8, 16, 24, 32])
def test_k6_options_fit_two_blocks_an_sm(Dh, bf16):
    """K6 with the options at every head dim the kernels take, each
    position bound up to 15 (the table and its rows are sized for 15,
    so b does not change the layout): two blocks an SM, each at most
    113 KB, as the release K6 (which the mirror gives as it was: 107,520
    bytes at fp32, 113,664 at bf16, Dh = 32)."""
    assert attention.pos_bound(attention.KERNEL_MAX_PATCH) == 15
    for rpe in (False, True):
        for b in range(16):
            assert 3 * (2 * b + 1) <= 96 and 2 * b + 1 <= 31
            smem = _k6_smem(Dh, bf16, rpe)
            assert smem <= K6_TWO_BLOCKS and smem <= 113 * 1024, \
                (Dh, bf16, rpe, smem)
    assert _k6_smem(32, bf16, False, release=True) == \
        (113664 if bf16 else 107520)
