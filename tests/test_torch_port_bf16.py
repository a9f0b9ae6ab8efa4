"""PyTorch port vs the JAX package at ptv3_config compute_dtype bfloat16.

The reference is the JAX package's XLA paths (attn_impl / conv_impl 'xla')
at compute_dtype 'bfloat16', jitted with XLA's excess precision off (the
compiler option xla_allow_excess_precision False): every bf16 op of the JAX
program is then rounded where the program rounds it. With it on, XLA on
the CPU keeps some fused intermediates in fp32 (jax.nn.gelu's -x sqrt(1/2),
a norm's output feeding a residual add), so the reference would depend on
how XLA fuses. Nothing in the JAX package changes for this.

At a small size on the CPU, from numpy seeds:
  * the kernels' plain versions at bf16 (the CPU path of the wrappers and
    the oracles of the CUDA kernels): K4 and K9 bit-equal to the JAX
    gathers; K1 against the JAX XLA attention (pallas_attention
    `_xla_reference`), K2 at 27 and 125 taps and K3 against the JAX
    subm_conv_apply at bf16, within the bar of ops/bf16.py (one bf16 ulp
    of the value, plus 1e-4 of the call's scale for fp32 sums in another
    order). The Pallas K1 body in interpret mode scales q after widening
    it to fp32 and so differs from the XLA path at bf16; its gap is
    measured and bounded here as information, and the port follows XLA;
  * the modules Dense, LayerNorm, MaskedBatchNorm, AdaptiveNorm, SubMConv,
    SerializedAttention and CrossAttention within that bar of the JAX
    module at bf16, and MLP, Block and CABlock (chains of them) within two
    bf16 ulps of the output scale on at most 2% of the elements; each
    with its output in bf16 and a port-fp32 output (the same weights, the
    fp32 state dict loaded strictly) further from the reference;
  * the whole eval forwards of SimplePolicyPTV3CA / AdaNorm / Concat and
    of MotionPlannerPTV3CA: a forward hook asserts bf16 activations in
    every backbone block, the heads are fp32 and within HEAD_TOL *
    max(1, |ref|) of the JAX heads at bf16 (HEAD_TOL = 0.02, tighter than
    the 0.08 bar of the JAX package's own bf16-vs-fp32 test), the port at
    bf16 is closer to them than the port at fp32 is, and the decoded
    actions agree wherever the reference's top-2 logit margin exceeds the
    tolerance;
  * an fp32 model file served at bf16 through Actioner and
    MotionPlannerEngine (the state loaded with strict=True), the YAML key
    and the CLI override, predict_batch against predict.
Training at bf16: test_torch_port_bf16_train.py (the backward kernels'
plain versions) and test_torch_port_bf16_train_step.py (whole steps). The
bf16 CUDA kernels against these plain versions: test_torch_port_gpu.py
and chip_smoke.py.
"""
import numpy as np
import pytest
import torch
import yaml
import jax
import jax.numpy as jnp

from robot3dlotus_tpu.models import layers as jl
from robot3dlotus_tpu.models.motion_planner import (
    MotionPlannerTPU, decode_mp_actions as jdecode_mp)
from robot3dlotus_tpu.models.simple_policy import (
    SimplePolicyTPU, decode_actions as jdecode)
from robot3dlotus_tpu.ops import pallas_attention as jattn
from robot3dlotus_tpu.ops import pallas_gather as jgather
from robot3dlotus_tpu.ops.patching import build_pad_maps as jpad_maps
from robot3dlotus_tpu.ops.sparse_conv import (
    build_neighbor_map as jneighbor_map, subm_conv_apply)
from robot3dlotus_tpu_torch.convert import params_to_jax
from robot3dlotus_tpu_torch.eval import robot_pipeline as pipe
from robot3dlotus_tpu_torch.eval.actioner import Actioner
from robot3dlotus_tpu_torch.eval.synthetic_obs import synthetic_observation
from robot3dlotus_tpu_torch.models import layers as tl
from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.models.motion_planner import decode_mp_actions
from robot3dlotus_tpu_torch.models.simple_policy import (decode_actions,
                                                         ptv3_kwargs)
from robot3dlotus_tpu_torch.ops import attention, conv, gather, stem
from robot3dlotus_tpu_torch.ops.bf16 import bf16_excess
from robot3dlotus_tpu_torch.ops.patching import build_pad_maps
from robot3dlotus_tpu_torch.ops.sparse_conv import (build_neighbor_map,
                                                    categorical_conv)
from robot3dlotus_tpu_torch.train import checkpoint as ckpt
import test_torch_port_motion_planner as tmp_mp
from test_torch_port_train_step import ACT, PTV3
from test_torch_port_variants import (JAX_IMPL, carried, perturb_port,
                                      policy_batch)

BF16 = torch.bfloat16
HEAD_TOL = 0.02
NO_EXCESS = {"xla_allow_excess_precision": False}


def T(a):
    return torch.from_numpy(np.array(a))


def jrun(fn, *args):
    """fn jitted with XLA's excess precision off (the module docstring)."""
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)(
        *args)


def f32(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def jbf(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def tbf(a):
    return T(np.asarray(a, np.float32)).to(BF16)


def within_bar(got, want, extra=None):
    """got (torch) within the ops/bf16.py bar of want (JAX or torch)."""
    w = torch.from_numpy(f32(want))
    assert bf16_excess(got, w, extra=extra) <= 0.0, \
        np.abs(f32(got) - w.numpy()).max()


# ------------------------------------------------------ plain kernels -----

@pytest.mark.parametrize("D", [7, 64, 96])
def test_k4_plain_bf16_bit_equal(D):
    rng = np.random.RandomState(D)
    x = rng.randn(2, 33, D).astype(np.float32)
    idx = rng.randint(0, 33, (2, 70)).astype(np.int32)
    got = gather.gather_rows(tbf(x), T(idx))
    assert got.dtype == BF16
    want = jgather.permute_rows(jbf(x), jnp.asarray(idx), impl="xla")
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize("C", [5, 8, 24])
def test_k9_plain_bf16_bit_equal(C):
    """Sentinel rows (== N and negative) gather zero rows in both."""
    rng = np.random.RandomState(C)
    x = rng.randn(2, 256, C).astype(np.float32)
    idx = rng.randint(0, 256, (2, 500))
    idx[rng.rand(2, 500) < 0.2] = 256
    got = gather.gather_rows_smallc(tbf(x), T(idx))
    want = jgather.gather_rows_smallc(jbf(x), jnp.asarray(idx, jnp.int32),
                                      interpret=True)
    assert got.dtype == BF16
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize("G,H,P,Dh", [(4, 2, 16, 8), (3, 2, 37, 24),
                                      (2, 4, 128, 32)])
def test_k1_plain_bf16_matches_jax_xla(G, H, P, Dh):
    """K1's plain version at bf16 against the JAX XLA attention (q * scale
    in bf16, the probabilities cast to bf16): within the bar plus one bf16
    ulp of each probability's share (bf16_probability_allowance). The
    Pallas body in interpret mode (q * scale in fp32) is measured against
    the XLA path as information: it differs by up to a few bf16 ulps of
    the output, the port by the bar."""
    rng = np.random.RandomState(G * P + Dh)
    q, k, v = (rng.randn(G, H, P, Dh).astype(np.float32) for _ in range(3))
    kv = rng.rand(G, P) > 0.25
    kv[0] = False
    scale = Dh ** -0.5
    targs = (tbf(q), tbf(k), tbf(v), T(kv), scale)
    got = attention.patch_attention(*targs)
    assert got.dtype == BF16
    jargs = (jbf(q), jbf(k), jbf(v), jnp.asarray(kv))
    xla = jrun(lambda a, b, c, d: jattn._xla_reference(a, b, c, d, scale),
               *jargs)
    within_bar(got, xla, attention.bf16_probability_allowance(*targs))
    pallas = jattn.patch_attention(*jargs, scale, True)
    gap = np.abs(f32(pallas) - f32(xla)).max()
    assert gap <= 0.05 * max(1.0, np.abs(f32(xla)).max()), gap


def _cloud(seed, B=2, N=96, span=8):
    rng = np.random.RandomState(seed)
    gc = np.stack([np.stack(np.unravel_index(
        rng.choice(span ** 3, N, replace=False), (span,) * 3), -1)
        for _ in range(B)]).astype(np.int32)
    counts = np.array([N, N - 11][:B])
    mask = np.arange(N)[None] < counts[:, None]
    return rng, gc, counts, mask


@pytest.mark.parametrize("k,cin,cout", [(3, 32, 32), (3, 64, 48),
                                        (5, 263, 64)])
def test_k2_plain_bf16_matches_jax_xla(k, cin, cout):
    """The CPE conv and the Concat stem's 125 taps: fp32 sums over every
    tap, the fp32 bias, one rounding."""
    rng, gc, counts, mask = _cloud(k + cin)
    nm = jneighbor_map(jnp.asarray(gc), jnp.asarray(mask), k, 3, extent=8)
    x = (rng.randn(2, 96, cin) * mask[..., None]).astype(np.float32)
    w = (rng.randn(k ** 3, cin, cout) * (k ** 3 * cin) ** -0.5).astype(
        np.float32)
    b = rng.randn(cout).astype(np.float32)
    got = conv.subm_conv(tbf(x), T(nm.idx), T(nm.ok), tbf(w), T(b))
    assert got.dtype == BF16
    want = jrun(lambda a, c, d: subm_conv_apply(a, nm, c, d), jbf(x),
                jbf(w), jnp.asarray(b))
    within_bar(got, want)


@pytest.mark.parametrize("cin", [7, 8])
def test_k3_plain_bf16_matches_jax_xla(cin):
    rng, gc, counts, mask = _cloud(cin, N=128)
    nm = jneighbor_map(jnp.asarray(gc), jnp.asarray(mask), 5, 3, extent=8)
    x = rng.randn(2, 128, cin).astype(np.float32)
    w = (rng.randn(125, cin, 64) * 0.1).astype(np.float32)
    got = stem.stem_conv(tbf(x), T(nm.idx), T(nm.ok), tbf(w))
    assert got.dtype == BF16
    want = jrun(lambda a, c: subm_conv_apply(a, nm, c), jbf(x), jbf(w))
    within_bar(got, want)


def test_categorical_conv_bf16_matches_jax():
    """The motion planner's stem: bf16 rows and the one-based label channel
    through K9's plain version, the one-hot x table in bf16, fp32 sums, one
    rounding; the JAX materialize_categorical + streaming conv at bf16."""
    rng, gc, counts, mask = _cloud(5, N=128)
    nm = jneighbor_map(jnp.asarray(gc), jnp.asarray(mask), 5, 3, extent=8)
    x = rng.randn(2, 128, 4).astype(np.float32)
    labels = rng.randint(0, 4, (2, 128))
    table = rng.randn(4, 8).astype(np.float32)
    w = (rng.randn(125, 12, 16) * 0.1).astype(np.float32)
    got = categorical_conv(tbf(x), build_neighbor_map(
        T(gc), T(mask), 5, 3, extent=8), tbf(w), (T(labels), T(table)))
    want = jrun(lambda a, c, t: subm_conv_apply(
        a, nm, c, categorical=(jnp.asarray(labels, jnp.int32), t)),
        jbf(x), jbf(w), jnp.asarray(table))
    within_bar(got.to(BF16), want)
    with pytest.raises(ValueError, match="bf16 index channel"):
        categorical_conv(tbf(x), build_neighbor_map(
            T(gc), T(mask), 5, 3, extent=8), tbf(w),
            (T(labels), T(np.zeros((300, 8), np.float32))))


# ------------------------------------------------------------- modules -----

B, N, C, H, P = 2, 64, 32, 2, 16


@pytest.fixture(scope="module")
def inputs():
    rng, gc, counts, mask = _cloud(11, N=N)
    feat = (rng.randn(B, N, C) * mask[..., None]).astype(np.float32)
    ctx = rng.randn(B, 5, 24).astype(np.float32)
    cmask = np.ones((B, 5), bool)
    cmask[1, 3:] = False
    cvec = rng.randn(B, 24).astype(np.float32)
    sp, kv = build_pad_maps(T(counts), N, P)
    jsp, jkv = jpad_maps(jnp.asarray(counts), N, P)
    taux = {"order": [None] * 4, "inverse": [None] * 4, "src_pos": sp,
            "key_valid": kv, "counts": T(counts).long(), "mask": T(mask),
            "cpe_nmap": build_neighbor_map(T(gc), T(mask), 3, 3, extent=8)}
    jaux = {"order": [None] * 4, "inverse": [None] * 4, "src_pos": jsp,
            "key_valid": jkv, "counts": jnp.asarray(counts),
            "mask": jnp.asarray(mask),
            "cpe_nmap": jneighbor_map(jnp.asarray(gc), jnp.asarray(mask), 3,
                                      3, extent=8)}
    return dict(feat=feat, ctx=ctx, cmask=cmask, cvec=cvec, mask=mask,
                taux=taux, jaux=jaux)


def _dt(dt):
    return None if dt is None else jnp.bfloat16


MODULES = {
    # name: (port module(dtype), JAX module(dtype), port args(inputs, bf16),
    #        JAX args(inputs), JAX kwargs, composite)
    "dense": (lambda g, dt: tl.dense(C, 48, g, dtype=dt),
              lambda dt: jl.dense(48, dtype=_dt(dt)),
              lambda i, bf: (bf(i["feat"]),),
              lambda i: (jbf(i["feat"]),), {}, False),
    "layernorm": (lambda g, dt: tl.LayerNorm(C, eps=1e-5),
                  lambda dt: jl.LayerNorm(C),
                  lambda i, bf: (bf(i["feat"]),),
                  lambda i: (jbf(i["feat"]),), {}, False),
    "batchnorm": (lambda g, dt: tl.MaskedBatchNorm(C),
                  lambda dt: jl.MaskedBatchNorm(C),
                  lambda i, bf: (bf(i["feat"]), T(i["mask"])),
                  lambda i: (jbf(i["feat"]), jnp.asarray(i["mask"])),
                  {"use_running_average": True}, False),
    "adaptive_norm": (
        lambda g, dt: tl.AdaptiveNorm(C, "ln", g, True, 24, dtype=dt),
        lambda dt: jl.AdaptiveNorm(C, "ln", True, 24, dtype=_dt(dt)),
        lambda i, bf: (bf(i["feat"]), None, T(i["cvec"])),
        lambda i: (jbf(i["feat"]), None, jnp.asarray(i["cvec"])), {},
        False),
    "subm_conv": (lambda g, dt: tl.SubMConv(C, C, 3, g, dtype=dt),
                  lambda dt: jl.SubMConv(C, 3, dtype=_dt(dt)),
                  lambda i, bf: (bf(i["feat"]), i["taux"]["cpe_nmap"]),
                  lambda i: (jbf(i["feat"]), i["jaux"]["cpe_nmap"]), {},
                  False),
    "serialized_attention": (
        lambda g, dt: tl.SerializedAttention(C, H, P, g, dtype=dt),
        lambda dt: jl.SerializedAttention(C, H, P, qk_norm=True,
                                          dtype=_dt(dt), attn_impl="xla"),
        lambda i, bf: (bf(i["feat"]), i["taux"]),
        lambda i: (jbf(i["feat"]), [None] * 4, [None] * 4,
                   i["jaux"]["src_pos"], i["jaux"]["key_valid"]),
        "counts", False),
    "cross_attention": (
        lambda g, dt: tl.CrossAttention(C, H, 24, g, dtype=dt),
        lambda dt: jl.CrossAttention(C, H, qk_norm=True, dtype=_dt(dt)),
        lambda i, bf: (bf(i["feat"]), bf(i["ctx"]), T(i["cmask"])),
        lambda i: (jbf(i["feat"]), jbf(i["ctx"]), jnp.asarray(i["cmask"])),
        {}, False),
    "mlp": (lambda g, dt: tl.MLP(C, 4 * C, C, g, dtype=dt),
            lambda dt: jl.MLP(4 * C, C, dtype=_dt(dt)),
            lambda i, bf: (bf(i["feat"]),),
            lambda i: (jbf(i["feat"]),), {}, True),
    "block": (lambda g, dt: tl.Block(C, H, P, g, dtype=dt),
              lambda dt: jl.Block(C, H, P, qk_norm=True, dtype=_dt(dt),
                                  attn_impl="xla"),
              lambda i, bf: (bf(i["feat"]), i["taux"]),
              lambda i: (jbf(i["feat"]), i["jaux"]), {}, True),
    "cablock": (lambda g, dt: tl.CABlock(C, H, 24, g, dtype=dt),
                lambda dt: jl.CABlock(C, H, qk_norm=True, dtype=_dt(dt)),
                lambda i, bf: (bf(i["feat"]), bf(i["ctx"]), T(i["cmask"])),
                lambda i: (jbf(i["feat"]), jbf(i["ctx"]),
                           jnp.asarray(i["cmask"]), i["jaux"]), {}, True),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_module_bf16_matches_jax(name, inputs):
    make, jmake, targs, jargs, jkw, composite = MODULES[name]
    if jkw == "counts":
        jkw = {"counts": inputs["jaux"]["counts"]}
    port = perturb_port(make(torch.Generator().manual_seed(0), BF16)).eval()
    port32 = make(torch.Generator().manual_seed(0), None).eval()
    port32.load_state_dict(port.state_dict(), strict=True)
    variables = {k: v for k, v in params_to_jax(port).items() if v}
    jm = jmake(BF16)
    want = f32(jrun(lambda v, *a: jm.apply(v, *a, **jkw), variables,
                    *jargs(inputs)))
    with torch.inference_mode():
        got = port(*targs(inputs, tbf))
        got32 = port32(*targs(inputs, T))
    assert got.dtype == BF16 and got32.dtype == torch.float32
    d = np.abs(f32(got) - want)
    scale = max(1.0, np.abs(want).max())
    if composite:
        # one rounding flip inside the chain moves an output by a few ulps
        assert d.max() <= 2.0 ** -6 * scale and (d > 0).mean() <= 0.02
    else:
        within_bar(got, want)
    assert np.abs(f32(got32) - want).max() > 2 * d.max()


# ------------------------------------------------------ whole forwards -----

def _jax_policy(cfg, variant):
    return SimplePolicyTPU(ptv3_cfg=dict(cfg["ptv3_config"], **JAX_IMPL),
                           act_cfg=cfg["action_config"], variant=variant)


def _assert_bf16_backbone(model):
    """Forward hooks on every backbone Block / CABlock / pooling: each
    returns bf16 activations; they restore nothing and count the calls."""
    seen = []

    def hook(mod, args, out):
        feat = out[0] if isinstance(out, tuple) else out
        seen.append(feat.dtype)
    handles = [m.register_forward_hook(hook)
               for n, m in model.ptv3_model.named_modules()
               if type(m).__name__ in ("Block", "CABlock",
                                       "SerializedPooling",
                                       "SerializedUnpooling")]
    return seen, handles


def _margin_ok(ref_logits, axis):
    """Where the reference's top-2 margin along `axis` exceeds the head
    tolerance (scaled as the logits' bar)."""
    srt = np.sort(ref_logits, axis=axis)
    top2 = np.take(srt, [-1], axis=axis) - np.take(srt, [-2], axis=axis)
    tol = HEAD_TOL * max(1.0, np.abs(ref_logits[ref_logits > -1e8]).max())
    return np.squeeze(top2, axis) > 2 * tol


def _heads_close(got, got32, want, keys):
    """Every head within HEAD_TOL * max(1, |ref|) of the JAX bf16 heads over
    the unmasked entries, fp32, and closer than the port at fp32."""
    gaps = []
    for k in keys:
        w = np.asarray(want[k])
        live = w > -1e8
        g, g32 = got[k], got32[k]
        assert g.dtype == torch.float32
        tol = HEAD_TOL * max(1.0, np.abs(w[live]).max())
        d = np.abs(g.numpy() - w)[live].max()
        d32 = np.abs(g32.numpy() - w)[live].max()
        assert d <= tol, (k, d, tol)
        gaps.append((d, d32))
    assert sum(d for d, _ in gaps) < sum(d32 for _, d32 in gaps), gaps


POLICIES = {"SimplePolicyPTV3CA": "ca", "SimplePolicyPTV3AdaNorm": "adanorm",
            "SimplePolicyPTV3Concat": "concat"}


@pytest.mark.parametrize("cls", list(POLICIES))
def test_policy_forward_bf16_matches_jax(cls):
    variant = POLICIES[cls]
    ptv3 = dict(PTV3, shuffle_orders=False, pdnorm_adaptive=True,
                compute_dtype="bfloat16")
    cfg = {"model_class": cls, "ptv3_config": ptv3, "action_config": ACT}
    batch = policy_batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = _jax_policy(cfg, variant)
    port, variables = carried(cfg, jm, jb)
    port32 = build_model(dict(cfg, ptv3_config=dict(
        ptv3, compute_dtype=None)), device="cpu")
    port32.load_state_dict(port.state_dict(), strict=True)
    want, jact = jrun(lambda v, bb: (lambda p: (
        {k: p[k] for k in ("pos", "rot", "open")}, jdecode(p, ACT)))(
            jm.apply(v, bb, deterministic=True)), variables, jb)
    seen, handles = _assert_bf16_backbone(port)
    with torch.inference_mode():
        tb = {k: T(v) for k, v in batch.items()}
        got = port(tb)
        got32 = port32(tb)
        act = decode_actions(got, ACT).numpy()
    for h in handles:
        h.remove()
    assert len(seen) >= 4 and all(d == BF16 for d in seen), seen
    _heads_close(got, got32, want, ("pos", "rot", "open"))
    jact = np.asarray(jact)
    pos = np.asarray(want["pos"]).reshape(2, 3, -1)
    sure = _margin_ok(pos, -1)
    assert sure.any()
    np.testing.assert_allclose(act[:, :3][sure], jact[:, :3][sure],
                               atol=1e-6, rtol=0)
    rot = np.asarray(want["rot"])                        # (B, bins, 3)
    sure = _margin_ok(rot, 1)
    np.testing.assert_array_equal(got["rot"].numpy().argmax(1)[sure],
                                  rot.argmax(1)[sure])
    np.testing.assert_allclose(act[:, -1], jact[:, -1],
                               atol=HEAD_TOL * max(1.0, np.abs(
                                   jact[:, -1]).max()), rtol=0)


def test_motion_planner_forward_bf16_matches_jax():
    ptv3 = dict(tmp_mp.PTV3, shuffle_orders=False, compute_dtype="bfloat16")
    cfg = {"model_class": "MotionPlannerPTV3CA", "ptv3_config": ptv3,
           "action_config": tmp_mp.ACT}
    batch = tmp_mp.mp_batch(0)
    batch = {k: v for k, v in batch.items()
             if k in ("pc_fts", "pc_mask", "pc_counts", "txt_embeds",
                      "txt_mask", "pc_labels")}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = MotionPlannerTPU(ptv3_cfg=dict(ptv3, **JAX_IMPL), act_cfg=tmp_mp.ACT,
                          variant="ca")
    port, variables = carried(cfg, jm, jb)
    port32 = build_model(dict(cfg, ptv3_config=dict(
        ptv3, compute_dtype=None)), device="cpu")
    port32.load_state_dict(port.state_dict(), strict=True)
    keys = ("pos", "rot", "open", "stop")
    want, jact = jrun(lambda v, bb: (lambda p: (
        {k: p[k] for k in keys}, jdecode_mp(p, tmp_mp.ACT)))(
            jm.apply(v, bb, deterministic=True)), variables, jb)
    seen, handles = _assert_bf16_backbone(port)
    with torch.inference_mode():
        tb = {k: T(v) for k, v in batch.items()}
        got, got32 = port(tb), port32(tb)
        act = decode_mp_actions(got, tmp_mp.ACT).numpy()
    for h in handles:
        h.remove()
    assert seen and all(d == BF16 for d in seen)
    _heads_close(got, got32, want, keys)
    pos = np.asarray(want["pos"])                        # (B, L, 3, N, nb)
    sure = _margin_ok(pos.reshape(*pos.shape[:3], -1), -1)
    assert sure.any()
    np.testing.assert_allclose(act[..., :3][sure],
                               np.asarray(jact)[..., :3][sure], atol=1e-6,
                               rtol=0)


# ------------------------------------------- serving and the entry points --

def _policy_config(tmp_path, compute_dtype=None):
    model = {"model_class": "SimplePolicyPTV3CA",
             "ptv3_config": dict(PTV3, stage_caps=[128] * 2,
                                 compute_dtype=compute_dtype),
             "action_config": ACT}
    path = str(tmp_path / f"config_{compute_dtype}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"TRAIN_DATASET": {"num_points": 128},
                        "MODEL": model}, f)
    return path


@pytest.mark.parametrize("how", ["yaml", "cli"])
def test_fp32_checkpoint_serves_at_bf16(tmp_path, how):
    """A model file saved from the fp32 model loads strictly into the bf16
    Actioner (the YAML key, or the CLI override on the fp32 YAML): the
    same state, a backbone in bf16, an action within the JAX package's
    0.08 bar of the fp32 Actioner's; predict_batch agrees with predict,
    and a shuffled 2-member 'ens1' ensemble serves at bf16."""
    ref = Actioner(_policy_config(tmp_path), device="cpu", seed=3)
    perturb_port(ref.model)
    path = ckpt.ModelSaver(str(tmp_path / "run")).save(ref.model, 1)
    if how == "yaml":
        a = Actioner(_policy_config(tmp_path, "bfloat16"), checkpoint=path,
                     device="cpu")
    else:
        a = Actioner(_policy_config(tmp_path), checkpoint=path,
                     device="cpu", cli_opts=[
                         "MODEL.ptv3_config.compute_dtype", "bfloat16"])
    assert a.model.ptv3_model.compute_dtype == BF16
    for k, v in ref.model.state_dict().items():
        assert torch.equal(a.model.state_dict()[k], v), k
    obs = [synthetic_observation(3 + i, cameras=1, height=32, width=32)
           for i in range(2)]
    reqs = [dict(task_str="close_jar", variation=i, step_id=0,
                 obs_state_dict=o) for i, o in enumerate(obs)]
    seen, handles = _assert_bf16_backbone(a.model)
    a.rng = np.random.default_rng(0)
    acts = [a.predict(**r)["action"] for r in reqs]
    for h in handles:
        h.remove()
    assert seen and all(d == BF16 for d in seen)
    assert all(x.shape == (8,) and np.isfinite(x).all() for x in acts)
    ref.rng = np.random.default_rng(0)
    want = ref.predict(**reqs[0])["action"]
    assert np.abs(acts[0] - want).max() < 0.08 * max(1.0, np.abs(want).max())
    a.rng = np.random.default_rng(0)
    batched = [o["action"] for o in a.predict_batch(reqs)]
    for x, y in zip(acts, batched):
        np.testing.assert_allclose(x, y, atol=HEAD_TOL, rtol=0)
    if how == "cli":
        # shuffled ensemble members: bf16 entry sorts at the pooled stages
        ens = Actioner(_policy_config(tmp_path, "bfloat16"),
                       checkpoint=path, device="cpu", num_ensembles=2,
                       best_disc_pos="ens1")
        ens.rng = np.random.default_rng(0)
        x = ens.predict(**reqs[0])["action"]
        assert x.shape == (8,) and np.isfinite(x).all()


def test_motion_planner_engine_serves_fp32_file_at_bf16(tmp_path):
    """MotionPlannerEngine and the GT pipeline at bf16 from an fp32 file:
    strict load, a bf16 backbone, a finite trajectory within the JAX bar of
    the fp32 engine's."""
    model = dict(tmp_mp.MP_MODEL, ptv3_config=dict(tmp_mp.PTV3,
                                                   stage_caps=[256, 256]),
                 action_config=dict(tmp_mp.ACT, txt_ft_size=512))
    cfg_path = str(tmp_path / "mp.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"TRAIN_DATASET": {"num_points": 256},
                        "MODEL": model}, f)
    ref = pipe.MotionPlannerEngine(cfg_path, device="cpu", seed=2)
    perturb_port(ref.model)
    path = ckpt.ModelSaver(str(tmp_path / "run")).save(ref.model, 1)
    e = pipe.MotionPlannerEngine(cfg_path, checkpoint=path, device="cpu",
                                 cli_opts=["MODEL.ptv3_config.compute_dtype",
                                           "bfloat16"])
    assert e.model.ptv3_model.compute_dtype == BF16
    rng = np.random.RandomState(0)
    n = 200
    args = (rng.randn(n, 4).astype(np.float32), rng.randint(0, 4, n),
            rng.randn(3, 512).astype(np.float32), np.zeros(8, np.float32),
            np.zeros(3), 1.0, 0.0)
    got, want = e.predict(*args), ref.predict(*args)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() < 0.08 * max(1.0, np.abs(want).max())
    p = pipe.GroundtruthRobotPipeline(tmp_mp.GT_CFG, motion_planner=e)
    p.vision.rng = np.random.RandomState(9)
    out = p.predict(task_str="push_button", variation=0, step_id=0,
                    obs_state_dict=synthetic_observation(
                        20, cameras=2, height=96, width=96), episode_id=0)
    assert out["action"].shape == (8,) and np.isfinite(out["action"]).all()


def test_ptv3_kwargs_accepts_compute_dtype_and_names_missing_options():
    assert ptv3_kwargs({"compute_dtype": "bfloat16"}) == {
        "compute_dtype": "bfloat16"}
    # the attention options pass through (test_torch_port_attn_options.py
    # holds the model they build); an unknown truthy option still raises
    assert ptv3_kwargs({"add_coords_in_attn": "none"}) == {
        "add_coords_in_attn": "none"}
    for opt, v in (("enable_rpe", True), ("scaled_cosine_attn", True),
                   ("upcast_attention", True), ("add_coords_in_attn", "qk")):
        assert ptv3_kwargs({opt: v}) == {opt: v}
    with pytest.raises(ValueError, match="no_such_option"):
        ptv3_kwargs({"no_such_option": True})
    with pytest.raises(ValueError, match="float32 .None. or bfloat16"):
        build_model({"model_class": "SimplePolicyPTV3CA",
                     "ptv3_config": dict(PTV3, compute_dtype="float16"),
                     "action_config": ACT}, device="cpu")


@pytest.mark.parametrize("child_cap", [48, 20])
def test_segment_reduce_bf16_matches_jax(child_cap):
    """Pooling reduces in the values' dtype in both packages: 'max' (the
    release configs') is exact, bit-equal; 'mean' sums in bf16, each
    segment's adds rounded, so it is held within 2^-6 x max(1, |ref|)
    (a few bf16 ulps over segments of at most 8 points)."""
    from robot3dlotus_tpu.ops import pooling as jpool
    from robot3dlotus_tpu_torch.ops import pooling as tpool
    from test_torch_port_ops import _sorted_codes
    codes, counts = _sorted_codes(4, child_cap)
    jm = jpool.build_pool_maps(jnp.asarray(codes), None, None,
                               jnp.asarray(counts), child_cap)
    tm = tpool.build_pool_maps(T(codes), T(counts).long(), child_cap)
    vals = np.random.RandomState(5).randn(*codes.shape, 6).astype(
        np.float32)
    for red in ("max", "mean"):
        want = f32(jrun(lambda v: jpool.segment_reduce(v, jm, child_cap, red),
                        jbf(vals)))
        got = tpool.segment_reduce(tbf(vals), tm, child_cap, red)
        assert got.dtype == BF16
        if red == "max":
            np.testing.assert_array_equal(f32(got), want)
        else:
            np.testing.assert_allclose(
                f32(got), want, rtol=0,
                atol=2.0 ** -6 * max(1.0, np.abs(want).max()))
