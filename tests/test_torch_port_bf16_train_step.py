"""PyTorch port vs the JAX package: one whole training step of the policy
at ptv3_config compute_dtype bfloat16.

A tiny SimplePolicyPTV3CA (2 stages, widths 16-32, dropout 0, orders
shuffled with the same injected permutations on both sides) with the
seeded, perturbed port weights carried to the JAX tree by params_to_jax
(its structure and shapes checked against jax.eval_shape of the JAX init,
so no JAX init is compiled). The reference is the JAX make_train_step (and
jax.value_and_grad of the same loss for the gradients) on the XLA paths
at compute_dtype 'bfloat16', compiled with XLA's excess precision off, as
tests/test_torch_port_bf16.py compiles its references: every bf16 op
rounded where the program rounds it. The port's Trainer takes the same
step at bf16 (fp32 master weights, AdamW state and losses; bf16
activations and cotangents) and, from the same weights, at fp32.

Bars (the port at bf16 against the JAX step at bf16):
  * losses and the batch-norm running statistics within 1e-3 * max(1,
    |ref|): the losses are fp32 functions of fp32 heads whose inputs come
    from the bf16 backbone, where a rounding taken on the other side of a
    tie moves an activation by one bf16 ulp;
  * every gradient within GRAD_BAR = 2^-2 of max(its leaf's largest
    |grad|, GRAD_FLOOR = 2e-2 of the largest |grad| of all leaves, gmax).
    The two sides round in different places: the JAX XLA conv's VJP
    rounds each tap's dx product and sums the taps in bf16, and XLA sums a
    bias's bf16 cotangent over the points in bf16, where the port follows
    the TPU kernels (one rounding after fp32 sums) and PyTorch sums in
    fp32. A bias's gradient is such a sum of many cancelling terms and
    moves by a sizeable part of its own scale (up to ~0.25 of it on the
    fp32 port too), which the floor bounds. A leaf whose gradient is zero
    in exact arithmetic (a bias in front of a batch norm: the port's fp32
    gradient is below 1e-6 gmax) holds only the two sides' bf16 rounding
    noise: both within ZERO_BAR = 2^-6 gmax of 0;
  * updated parameters within 1e-4 * max(1, |ref|) wherever the reference
    gradient's sign is determined (|grad| above the gradient bar), else
    within 2 lr (Adam's first step moves an element by about lr sign(g)).
And the discriminating check: the port at bf16 is nearer the JAX step at
bf16 than the port at fp32 (the same weights) is, on the largest loss
difference, the running statistics and the gradients as a whole (the
relative L2 distance over all leaves).

The motion planner's step: test_torch_port_bf16_mp_train_step.py.
"""
import numpy as np
import torch
import jax
import jax.numpy as jnp

from robot3dlotus_tpu.models.simple_policy import compute_loss as jloss
from robot3dlotus_tpu.train.optim import build_optimizer as jbuild_optimizer
from robot3dlotus_tpu.train.trainer import TrainState, make_train_step
from robot3dlotus_tpu_torch.convert import params_from_jax
from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.models.layers import Randomness
from robot3dlotus_tpu_torch.models.simple_policy import compute_loss
from robot3dlotus_tpu_torch.train.optim import build_optimizer
from robot3dlotus_tpu_torch.train.trainer import Trainer, batch_to_device
from test_torch_port_train_step import LOSS, TRAIN
from test_torch_port_variants import (carried, jax_policy, model_cfg,
                                      policy_batch)

NO_EXCESS = {"xla_allow_excess_precision": False}
STATE_BAR = 1e-3
GRAD_BAR = 2.0 ** -2
GRAD_FLOOR = 2e-2
ZERO_BAR = 2.0 ** -6
UPDATE_BAR = 1e-4


def T(a):
    return torch.from_numpy(np.array(a))


def _compiled(fn, *args):
    """fn (a jitted function) lowered and compiled with excess precision
    off, then called."""
    return fn.lower(*args).compile(compiler_options=NO_EXCESS)(*args)


def _port_step(model, loss_fn, batch, perms):
    opt, _ = build_optimizer(model, TRAIN)
    trainer = Trainer(model, loss_fn, opt, Randomness(0, perms=perms))
    losses = trainer.step(batch_to_device(batch, "cpu"))
    grads = {k: p.grad.detach().clone()
             for k, p in model.named_parameters()}
    return ({k: float(v) for k, v in losses.items()}, grads,
            {k: v.clone() for k, v in model.state_dict().items()})


def _rel(got, want):
    return abs(got - want) / max(1.0, abs(want))


def check_bf16_step(cfg16, jmodel, jloss_fn, loss_fn, batch, perms,
                    monkeypatch, must_learn=()):
    """One step of the port at bf16 (and at fp32, the same weights) against
    the JAX step at bf16 on the same carried weights and permutations; the
    bars and the discriminating check of the module docstring. Returns the
    measured distances (printed)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    port16, variables = carried(cfg16, jmodel, jb)
    cfg32 = dict(cfg16, ptv3_config=dict(cfg16["ptv3_config"],
                                         compute_dtype=None))
    port32 = build_model(cfg32, device="cpu")
    port32.load_state_dict(port16.state_dict(), strict=True)
    assert port16.ptv3_model.compute_dtype == torch.bfloat16
    # copies: params_to_jax's arrays share the port's parameter memory,
    # which the port's step updates in place
    variables = jax.tree_util.tree_map(lambda a: jnp.array(np.array(a)),
                                       variables)
    calls = []

    def permutation(rng, n):
        calls.append(n)
        return jnp.asarray(perms[(len(calls) - 1) % len(perms)])
    monkeypatch.setattr(jax.random, "permutation", permutation)
    key = jax.random.PRNGKey(0)

    def compute(params):
        preds, mutated = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jb,
            deterministic=False, rngs={"dropout": key, "shuffle": key},
            mutable=["batch_stats"])
        losses = jloss_fn(preds, jb)
        return losses["total"], (losses, mutated)
    (_, (jlosses, mutated)), jgrads = _compiled(
        jax.jit(jax.value_and_grad(compute, has_aux=True)),
        variables["params"])
    tx, _ = jbuild_optimizer(variables["params"], TRAIN)
    state = TrainState.create(apply_fn=jmodel.apply,
                              params=variables["params"], tx=tx,
                              batch_stats=variables["batch_stats"])
    new_state, step_losses = _compiled(
        make_train_step(jmodel, jloss_fn, donate=False), state, jb, key)
    jax.block_until_ready((jlosses, jgrads, mutated, new_state))

    before = {k: v.clone() for k, v in port16.state_dict().items()}
    l16, g16, s16 = _port_step(port16, loss_fn, batch, perms)
    l32, g32, s32 = _port_step(port32, loss_fn, batch, perms)
    assert set(l16) == set(jlosses)
    loss16 = max(_rel(l16[k], float(jlosses[k])) for k in jlosses)
    loss32 = max(_rel(l32[k], float(jlosses[k])) for k in jlosses)
    for k in jlosses:
        assert np.isfinite(l16[k]), k
        assert _rel(l16[k], float(jlosses[k])) <= STATE_BAR, (k, l16[k])
        assert _rel(float(step_losses[k]), float(jlosses[k])) <= 1e-6, k

    grads = {k: T(g) for k, g in params_from_jax({"params": jgrads}).items()}
    assert set(grads) == set(g16)
    scales = {k: float(g.abs().max()) for k, g in grads.items()}
    floor = GRAD_FLOOR * max(scales.values())
    for k in must_learn:
        assert scales[k] >= floor, k
    gmax = max(scales.values())
    zero = {k for k, g in g32.items() if float(g.abs().max()) <= 1e-6 * gmax}
    worst = 0.0
    for k, g in grads.items():
        assert g16[k].dtype == torch.float32, k
        if k in zero:
            assert max(scales[k], float(g16[k].abs().max())) <= \
                ZERO_BAR * gmax, k
            continue
        err = float((g16[k] - g).abs().max()) / max(scales[k], floor)
        worst = max(worst, err)
        assert err <= GRAD_BAR, (k, err)
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    dist = {d: float(torch.cat([g[k].reshape(-1) - grads[k].reshape(-1)
                                for k in grads]).norm() / flat.norm())
            for d, g in (("bf16", g16), ("fp32", g32))}

    updated = {k: T(v) for k, v in params_from_jax(
        {"params": new_state.params,
         "batch_stats": new_state.batch_stats}).items()}
    ref_stats = {k: T(v) for k, v in params_from_jax(
        {"params": {}, "batch_stats": mutated["batch_stats"]}).items()}
    assert set(updated) == set(s16)
    lr = TRAIN["learning_rate"]
    moved = max(float((updated[k] - before[k]).abs().max()) for k in grads)
    assert 0.5 * lr < moved < 2 * lr, moved     # Adam's first step
    for k, v in updated.items():
        if k not in grads:
            continue
        unsigned = grads[k].abs() <= (ZERO_BAR * gmax if k in zero else
                                      GRAD_BAR * max(scales[k], floor))
        diff = (s16[k] - v).abs()
        assert float(torch.where(unsigned, diff, 0.0).max()) <= 2 * lr, k
        assert float(torch.where(unsigned, 0.0, diff).max()) <= \
            UPDATE_BAR * max(1.0, float(v.abs().max())), k
    stats = {}
    for d, s in (("bf16", s16), ("fp32", s32)):
        stats[d] = max(float((s[k] - v).abs().max()) /
                       max(1.0, float(v.abs().max()))
                       for k, v in ref_stats.items())
    assert stats["bf16"] <= STATE_BAR
    out = {"loss": (loss16, loss32), "grad_l2": (dist["bf16"], dist["fp32"]),
           "stats": (stats["bf16"], stats["fp32"]), "grad_worst": worst,
           "leaves": len(grads), "zero_leaves": len(zero)}
    print(f"port bf16 vs port fp32 against JAX bf16: {out}")
    assert loss16 < loss32 and dist["bf16"] < dist["fp32"] and \
        stats["bf16"] < stats["fp32"], out
    return out


def test_policy_bf16_train_step_matches_jax(monkeypatch):
    cfg = model_cfg("SimplePolicyPTV3CA", {"compute_dtype": "bfloat16"})
    act = cfg["action_config"]
    check_bf16_step(
        cfg, jax_policy(cfg), lambda p, b: jloss(p, b, act, LOSS),
        lambda p, b: compute_loss(p, b, act, LOSS), policy_batch(seed=4),
        [[2, 0, 3, 1], [1, 3, 0, 2]], monkeypatch,
        must_learn=("txt_fc.weight", "ptv3_model.embedding_stem_conv.weight",
                    "ptv3_model.enc0_block0.cpe_conv.weight",
                    "ptv3_model.enc1_block0.attn.qkv.weight"))
