"""PyTorch port vs the JAX package: the optimizer menu and gradient
accumulation.

A slice of the tiny policy of test_torch_port_train_step.py (the text
projection, the stem conv and its norm, a decoder block with its CPE and
the action head: 35 leaves, seeded port weights carried to JAX by
convert.params_to_jax; the whole tree would only add JAX compile time)
and a seeded sequence of 8
gradients from numpy, in flax layout, go through the JAX build_optimizer
(optax, jitted) and the port's build_optimizer (set as .grad, step()):
adam, adamax, radam, ralamb, rangerlars (lookahead_k 3, so Lookahead syncs
in the run) and adamw with fused_optim False, each at
gradient_accumulation_steps 1 and 2, with lr_multi and freeze_params on in
one case each. After every step the parameters agree within 1e-4 of
max|p| (fp32, other summation orders). A mid-run resume of rangerlars at
accumulation 2, at a step that is not a multiple of 2, continues bit-equal
on the CPU; the train state crosses to the JAX package and back. Then one
whole training step pair at accumulation 2 against the JAX trainer
(make_train_step over optax.MultiSteps of the fused AdamW).
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn as nn
import jax
import jax.numpy as jnp
from flax import serialization as flax_ser

from robot3dlotus_tpu.models.simple_policy import (SimplePolicyTPU,
                                                   compute_loss as jloss)
from robot3dlotus_tpu.train import checkpoint as jckpt
from robot3dlotus_tpu.train.optim import build_optimizer as jbuild_optimizer
from robot3dlotus_tpu.train.trainer import TrainState, make_train_step
from robot3dlotus_tpu_torch.convert import (opt_state_to_jax, params_from_jax,
                                            params_to_jax)
from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.models.layers import Randomness
from robot3dlotus_tpu_torch.models.simple_policy import compute_loss
from robot3dlotus_tpu_torch.train import checkpoint as ckpt
from robot3dlotus_tpu_torch.train.optim import (FlatAdamW, MultiSteps,
                                                RangerLars, build_optimizer)
from robot3dlotus_tpu_torch.train.trainer import Trainer, batch_to_device
from test_torch_port_train_step import (ACT, LOSS, PERMS, PTV3, _batch,
                                        _close, _perturb)

MODEL = {"model_class": "SimplePolicyPTV3CA", "ptv3_config": PTV3,
         "action_config": ACT}
BAR = 1e-4          # of max|p|: the fp32 bar
STEPS = 8
BASE = {"learning_rate": 1e-2, "betas": [0.9, 0.98], "weight_decay": 0.05,
        "grad_norm": 3.0, "lr_sched": "cosine", "warmup_steps": 2,
        "num_train_steps": 20, "lookahead_k": 3, "lookahead_alpha": 0.5}
CASES = [(name, accum, {}) for name in ("adam", "adamax", "radam", "ralamb",
                                        "rangerlars", "adamw")
         for accum in (1, 2)]
CASES += [("radam", 2, {"lr_multi": {"ptv3_model/embedding": 0.5,
                                     "act_proj_head": 2.0}}),
          ("ralamb", 1, {"freeze_params": {"encoder": True}})]


def _cfg(name, accum, extra=None):
    cfg = dict(BASE, optim=name, gradient_accumulation_steps=accum,
               **(extra or {}))
    if name == "adamw":
        cfg["fused_optim"] = False
    return cfg


def _model(seed=0):
    """The slice of the tiny policy, under its flax names."""
    full = build_model(MODEL, device="cpu", seed=seed)
    tree = nn.Module()
    tree.txt_fc, tree.act_proj_head = full.txt_fc, full.act_proj_head
    tree.ptv3_model = nn.Module()
    for k in ("embedding_stem_conv", "embedding_norm", "dec0_block0"):
        setattr(tree.ptv3_model, k, getattr(full.ptv3_model, k))
    return tree


def _grads(model, n=STEPS, seed=5):
    """n seeded gradient trees in flax layout, of mixed scales (the clip
    binds on some steps, not on others)."""
    rng = np.random.RandomState(seed)
    shapes = params_to_jax(model)["params"]

    def draw(tree, scale):
        return {k: draw(v, scale) if isinstance(v, dict) else
                (rng.randn(*v.shape) * scale).astype(np.float32)
                for k, v in tree.items()}
    return [draw(shapes, s) for s in (0.01, 0.05, 0.002, 0.03, 0.01, 0.2,
                                      0.005, 0.02)[:n]]


def _set_grads(model, gtree):
    g = params_from_jax({"params": gtree})
    for name, p in model.named_parameters():
        p.grad = g[name].clone()


_JAX_TX = {}


def _jax_tx(params, cfg):
    """(tx, jitted (params, g, state) -> (params + update, state)), one
    compile per config."""
    key = repr(sorted(cfg.items()))
    if key not in _JAX_TX:
        tx, _ = jbuild_optimizer(params, cfg)

        @jax.jit
        def update(params, g, state):
            u, state = tx.update(g, state, params)
            return jax.tree_util.tree_map(lambda p, d: p + d, params,
                                          u), state
        _JAX_TX[key] = tx, update
    return _JAX_TX[key]


def _jax_run(params, cfg, grads, state=None):
    """The JAX optimizer's parameters after each step, and its state."""
    tx, update = _jax_tx(params, cfg)
    state = tx.init(params) if state is None else state
    out = []
    for g in grads:
        params, state = update(params, g, state)
        out.append(jax.tree_util.tree_map(np.asarray, params))
    return out, state


def _assert_close(model, want, what):
    got = params_to_jax(model)["params"]
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    scale = max(float(np.abs(v).max()) for v in flat_w.values())
    for path, w in flat_w.items():
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(g, w, rtol=0, atol=BAR * scale,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.fixture(scope="module")
def setup():
    model = _model()
    params = params_to_jax(model)["params"]
    return {"params": params, "grads": _grads(model),
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


@pytest.mark.parametrize("name,accum,extra", CASES,
                         ids=[f"{n}-k{a}" + ("-" + "-".join(e) if e else "")
                              for n, a, e in CASES])
def test_optimizer_matches_jax(setup, name, accum, extra):
    cfg = _cfg(name, accum, extra)
    want, _ = _jax_run(setup["params"], cfg, setup["grads"])
    model = _model()
    opt, _ = build_optimizer(model, cfg)
    assert isinstance(opt, MultiSteps) == (accum > 1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for i, g in enumerate(setup["grads"]):
        _set_grads(model, g)
        opt.step()
        _assert_close(model, want[i], f"{name} k={accum} step {i + 1}")
        if (i + 1) % accum:      # a micro-step moves nothing
            for k, v in model.state_dict().items():
                assert torch.equal(v, before[k]), (i, k)
        before = {k: v.clone() for k, v in model.state_dict().items()}
    assert opt.count == STEPS // accum
    if "freeze_params" in extra:
        frozen = [k for k in before if "ptv3_model.embedding" in k]
        assert frozen and all(torch.equal(before[k], setup["state"][k])
                              for k in frozen)


def test_unfused_adamw_is_flat_adamw(setup):
    """fused_optim False runs the same FlatAdamW (the optax chain gives the
    same update, held to JAX above): bit-equal to the fused run, only the
    checkpoint layout differs."""
    runs = []
    for fused in (True, False):
        model = _model()
        opt, _ = build_optimizer(model, _cfg("adamw", 1) | {
            "fused_optim": fused})
        assert isinstance(opt, FlatAdamW) and opt.fused == fused
        for g in setup["grads"]:
            _set_grads(model, g)
            opt.step()
        runs.append((model.state_dict(), opt_state_to_jax(opt, model)))
    for k, v in runs[0][0].items():
        assert torch.equal(v, runs[1][0][k]), k
    assert set(runs[0][1]) == {"count", "mu", "nu"}
    assert set(runs[1][1]) == {"0", "1"}     # clip, then the adamw chain


def test_rangerlars_holds_decay_mask_once(setup):
    """The RangerLars wrapper holds the clip and the lr multipliers, its
    Ralamb base the moments and the per-element decay mask: the mask is
    built once."""
    model = _model()
    opt, _ = build_optimizer(model, _cfg("rangerlars", 1, {
        "lr_multi": {"act_proj_head": 0.5}}))
    assert isinstance(opt, RangerLars)
    assert opt.wd_mask is None and opt.base.wd_mask is not None
    assert opt.mult is not None and opt.base.mult is None
    assert opt.max_norm and not opt.base.max_norm


def _same(a, b, path="opt_state"):
    """Equal trees: same keys, and leaves of the same dtype and bits."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _same(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    assert a.tobytes() == b.tobytes(), path


def _trainer_like(model, opt, step):
    return SimpleNamespace(model=model, optimizer=opt, global_step=step)


def test_resume_mid_accumulation_bit_equal(setup, tmp_path):
    """rangerlars at accumulation 2 (lookahead_k 2), saved after
    micro-step 5 (one gradient in the accumulator, Lookahead's slow
    weights taken at its first sync), resumed into a fresh optimizer: the
    remaining steps, a second sync among them, are bit-equal to the
    uninterrupted run's, moments, slow weights and accumulator too."""
    cfg = dict(_cfg("rangerlars", 2), lookahead_k=2)
    grads = setup["grads"]
    a = _model()
    opt_a, _ = build_optimizer(a, cfg)
    for g in grads[:5]:
        _set_grads(a, g)
        opt_a.step()
    assert opt_a.mini_step == 1 and opt_a.inner.initialized
    ckpt.ModelSaver(str(tmp_path)).save(a, 5, opt_a)
    b = _model(seed=9)
    opt_b, _ = build_optimizer(b, cfg)
    t = _trainer_like(b, opt_b, 0)
    assert ckpt.resume_or_init(t, str(tmp_path)) == 5
    assert t.global_step == 5 and opt_b.mini_step == 1 and opt_b.count == 2
    for g in grads[5:]:
        for m, o in ((a, opt_a), (b, opt_b)):
            _set_grads(m, g)
            o.step()
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    for key in ("acc",):
        assert torch.equal(getattr(opt_a, key), getattr(opt_b, key))
    for key in ("mu", "nu"):
        assert torch.equal(getattr(opt_a.inner.base, key),
                           getattr(opt_b.inner.base, key))
    assert torch.equal(opt_a.inner.slow, opt_b.inner.slow)


@pytest.mark.parametrize("name,accum", [("rangerlars", 2), ("adam", 1),
                                        ("adamw", 2)])
def test_train_state_crosses_packages(setup, tmp_path, name, accum):
    """The port's train_state_latest after 3 steps loads into the JAX
    optimizer's state (flax from_bytes against its template, leaf for
    leaf equal to the port's), and the JAX state after 3 steps resumes in
    the port: both then step on within the bar."""
    cfg = _cfg(name, accum, {"lr_multi": {"act_proj_head": 2.0}})
    if name == "adamw":
        cfg["fused_optim"] = True
    grads = setup["grads"]
    model = _model()
    opt, _ = build_optimizer(model, cfg)
    for g in grads[:3]:
        _set_grads(model, g)
        opt.step()
    pdir = str(tmp_path / "port")
    ckpt.ModelSaver(pdir).save(model, 3, opt)
    params = setup["params"]
    tx, _ = _jax_tx(params, cfg)
    template = tx.init(params)
    latest = jckpt.load_train_state_latest(pdir, template)
    jstate = latest["opt_state"]
    assert jax.tree_util.tree_structure(jstate) == \
        jax.tree_util.tree_structure(template)
    _same(flax_ser.to_state_dict(jstate), opt_state_to_jax(opt, model))

    # JAX from the port's state vs the port on: steps 4 and 5
    cont, _ = _jax_run(params_to_jax(model)["params"], cfg, grads[3:5],
                       jstate)
    for g in grads[3:5]:
        _set_grads(model, g)
        opt.step()
    _assert_close(model, cont[-1], f"{name} after a JAX resume")

    # the JAX run's state after 3 steps, resumed in the port
    ref, jstate3 = _jax_run(params, cfg, grads[:3])
    jdir = str(tmp_path / "jax")
    os.makedirs(os.path.join(jdir, "ckpts"))
    with open(os.path.join(jdir, "ckpts", "train_state_latest.msgpack"),
              "wb") as f:
        f.write(flax_ser.to_bytes({"step": np.int64(3),
                                   "opt_state": jstate3}))
    port = _model()
    port.load_state_dict(params_from_jax({
        "params": ref[-1], "batch_stats": params_to_jax(port)[
            "batch_stats"]}))
    ckpt.ModelSaver(jdir).save(port, 3)
    opt2, _ = build_optimizer(port, cfg)
    assert ckpt.resume_or_init(_trainer_like(port, opt2, 0), jdir) == 3
    for g in grads[3:5]:
        _set_grads(port, g)
        opt2.step()
    want, _ = _jax_run(params, cfg, grads[:5])
    _assert_close(port, want[-1], f"{name} after a port resume")


def test_wrong_optimizer_state_raises(setup, tmp_path):
    model = _model()
    opt, _ = build_optimizer(model, _cfg("radam", 1))
    ckpt.ModelSaver(str(tmp_path)).save(model, 1, opt)
    other, _ = build_optimizer(model, _cfg("adamax", 2))
    with pytest.raises(KeyError, match="opt_state"):
        ckpt.resume_or_init(_trainer_like(model, other, 0), str(tmp_path))
    with pytest.raises(ValueError, match="optim="):
        build_optimizer(model, {"optim": "sgd"})


def test_accumulated_train_steps_match_jax(monkeypatch):
    """Two micro-steps of the tiny policy at gradient_accumulation_steps 2
    against the JAX make_train_step over optax.MultiSteps (fused AdamW):
    the losses of both, the parameters unchanged after the first and
    updated after the second, within the train-step test's bars."""
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = SimplePolicyTPU(ptv3_cfg=dict(PTV3, attn_impl="xla",
                                          conv_impl="xla"),
                            act_cfg=ACT, variant="ca")
    key = jax.random.PRNGKey(0)
    port = build_model(MODEL, device="cpu", seed=2)
    variables = _perturb(params_to_jax(port))
    calls = []

    def permutation(rng, n):
        calls.append(n)
        return jnp.asarray(PERMS[(len(calls) - 1) % len(PERMS)])
    monkeypatch.setattr(jax.random, "permutation", permutation)
    cfg = dict(BASE, optim="adamw", gradient_accumulation_steps=2,
               learning_rate=1e-3)
    tx, _ = jbuild_optimizer(variables["params"], cfg)
    state = TrainState.create(apply_fn=model.apply,
                              params=variables["params"], tx=tx,
                              batch_stats=variables["batch_stats"])
    step_fn = make_train_step(
        model, lambda p, b: jloss(p, b, ACT, LOSS), donate=False)

    port.load_state_dict(params_from_jax(variables), strict=True)
    opt, _ = build_optimizer(port, cfg)
    trainer = Trainer(port, lambda p, b: compute_loss(p, b, ACT, LOSS), opt,
                      Randomness(0, perms=PERMS * 2))
    start = {k: v.clone() for k, v in port.state_dict().items()}
    for i in range(2):
        state, jlosses = step_fn(state, jb, key)
        losses = trainer.step(batch_to_device(batch, "cpu"))
        for k in jlosses:
            _close(losses[k], jlosses[k], k)
        sd = port.state_dict()
        updated = params_from_jax(jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats}))
        named = dict(port.named_parameters())
        for k, v in updated.items():
            if i == 0 and k in named:
                assert torch.equal(sd[k], start[k]), k
                assert np.array_equal(v.numpy(), start[k].numpy()), k
            if k in named and float(named[k].grad.abs().max()) < 1e-6:
                # a bias in front of a batch norm: a zero gradient up to
                # rounding, which Adam scales to ~lr (as in the step test)
                assert float((sd[k] - v).abs().max()) <= \
                    2 * cfg["learning_rate"], k
                continue
            _close(sd[k], v, f"micro-step {i + 1} {k}")
    assert trainer.global_step == 2 and opt.count == 1
    assert int(state.step) == 2


def test_leaf_norms_accurate_on_large_leaves():
    """Ralamb's per-tensor norms over a 4M-element leaf: within 1e-6 of
    the float64 norm (a float32 torch._foreach_norm is off by ~1e-4 on the
    CPU at this size)."""
    from robot3dlotus_tpu_torch.train.optim import Ralamb
    gen = torch.Generator().manual_seed(0)
    big = torch.nn.Parameter(torch.randn(4_000_000, generator=gen) * 0.005)
    small = torch.nn.Parameter(torch.randn(7, generator=gen))
    opt = Ralamb([("big", big), ("small", small)], lambda c: 1e-3)
    with torch.no_grad():
        got = opt._leaf_norms(opt._flat(opt.params))
    want = torch.stack([big.detach().double().norm(),
                        small.detach().double().norm()])
    assert got.dtype == torch.float32
    assert float(((got.double() - want) / want).abs().max()) <= 1e-6
