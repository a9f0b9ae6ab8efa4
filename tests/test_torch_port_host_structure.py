"""TRAIN.host_structure in the PyTorch port against the JAX package.

The port's attach_host_structure (train/datasets/structure.py) against the
JAX one on the same collated batches and draws: order_perm and every
presorted per-point row bit for bit, for the policy's and the motion
planner's batches, with each cloud's sorts computed in place or taken from
attach_sample_orders (what the loader's workers attach). The driver's
batches: build_trainer with the key True (2 worker processes) gives the
JAX loader's batches through the JAX driver's host-structure collate (its
RandomState(SEED + 131071)), bit for bit; with the key False, the plain
batches. One training step of the tiny policy of
test_torch_port_train_step.py on a host-structured batch (order_perm, no
redraw at any stage, no stage-0 entry sort) against the JAX
make_train_step on the JAX-attached batch, host-built stem and CPE maps
included: that test's bars (losses, updated parameters and statistics
1e-4 * max(1, |ref|); gradients 1e-4 of each leaf's largest |grad|,
floored at 1e-3 of the largest of all).
"""
import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robot3dlotus_tpu.models.simple_policy import (SimplePolicyTPU,
                                                   compute_loss as jloss)
from robot3dlotus_tpu.train.datasets import loader as jloader
from robot3dlotus_tpu.train.datasets import structure as jstructure
from robot3dlotus_tpu.train import train_simple_policy as \
    jtrain_simple_policy
from robot3dlotus_tpu.train.optim import build_optimizer as jbuild_optimizer
from robot3dlotus_tpu.train.trainer import TrainState, make_train_step
from robot3dlotus_tpu_torch.convert import params_from_jax
from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.models.layers import Randomness
from robot3dlotus_tpu_torch.models.simple_policy import compute_loss
from robot3dlotus_tpu_torch.train import train_simple_policy
from robot3dlotus_tpu_torch.train.datasets import structure
from robot3dlotus_tpu_torch.train.driver import build_trainer
from robot3dlotus_tpu_torch.train.optim import build_optimizer
from robot3dlotus_tpu_torch.train.trainer import Trainer, batch_to_device
import test_torch_port_train_step as ts
from test_torch_port_motion_planner import MP_MODEL, mp_batch
from torch_port_time_limit import time_limit  # noqa: F401

TIME_LIMIT_S = 180

POLICY_MODEL = {"ptv3_config": ts.PTV3, "action_config": ts.ACT}


def _cfgs(model_cfg):
    jcfg = jstructure.structure_cfg_from_model(
        {"ptv3_config": dict(model_cfg["ptv3_config"], lookup_extent=128),
         "action_config": model_cfg["action_config"]})
    return jcfg, structure.structure_cfg_from_model(model_cfg)


def _sample_orders(batch, cfg):
    """What attach_sample_orders gives each cloud of `batch`."""
    return [structure.attach_sample_orders(
        cfg, [{"pc_fts": batch["pc_fts"][b, :int(n)]}])[0][
        structure.ORDERS_KEY] for b, n in enumerate(batch["pc_counts"])]


@pytest.mark.parametrize("family", ["policy", "motion"])
@pytest.mark.parametrize("precomputed", [False, True])
def test_attach_host_structure_bit_equal_jax(family, precomputed):
    if family == "policy":
        batch, model_cfg = ts._batch(seed=4), POLICY_MODEL
    else:
        batch, model_cfg = mp_batch(seed=2), MP_MODEL
    jcfg, cfg = _cfgs(model_cfg)
    assert cfg["orders"] == jcfg["orders"] and cfg["shuffle"]
    jrng, rng = np.random.RandomState(131071), np.random.RandomState(131071)
    firsts = set()
    for _ in range(6):          # successive batches draw in turn
        want = jstructure.attach_host_structure(copy.deepcopy(batch), jcfg,
                                                jrng)
        got = structure.attach_host_structure(
            copy.deepcopy(batch), cfg, rng,
            _sample_orders(batch, cfg) if precomputed else None)
        np.testing.assert_array_equal(got["order_perm"], want["order_perm"])
        assert got["order_perm"].dtype == want["order_perm"].dtype
        firsts.add(int(got["order_perm"][0]))
        for k in batch:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert not np.array_equal(got["pc_fts"], batch["pc_fts"])
    assert len(firsts) > 1


def _tiny_config(host_structure, n_workers):
    return ts._tiny_release_config(host_structure=host_structure,
                                   n_workers=n_workers)


@pytest.mark.parametrize("host_structure", [True, False])
def test_driver_batches_equal_jax_driver(host_structure):
    """build_trainer's first 5 batches (2 worker processes, past the first
    epoch) against the JAX loader (2 threads) behind the JAX driver's
    collate: attach_host_structure with RandomState(SEED + 131071) when
    the key is True, the plain collate when it is False."""
    config = _tiny_config(host_structure, 2)
    _, batches, _ = build_trainer(config, train_simple_policy.SPEC,
                                  device="cpu")
    got = [next(batches) for _ in range(5)]
    batches.close()

    tds, seed = dict(config.TRAIN_DATASET), int(config.SEED)
    jds = jtrain_simple_policy.SPEC.build_dataset(
        dict(tds), np.random.RandomState(seed))
    collate = train_simple_policy.SPEC.make_collate(tds, 4)
    if host_structure:
        jcfg = jstructure.structure_cfg_from_model(
            {"ptv3_config": dict(config.MODEL.ptv3_config),
             "action_config": dict(config.MODEL.action_config)})
        jrng = np.random.RandomState(seed + 131071)
        plain = collate
        collate = lambda c: jstructure.attach_host_structure(  # noqa: E731
            plain(c), jcfg, jrng)
    it = iter(jloader.KeystepBatchLoader(
        jds, 4, int(tds["num_points"]), seed=seed, shuffle_seed=seed,
        process_index=0, process_count=1, num_workers=2,
        collate_fn=collate))
    want = [next(it) for _ in range(5)]
    for g, w in zip(got, want):
        if host_structure:
            w = {k: v for k, v in w.items()
                 if k == "order_perm" or not k.startswith(("stem_", "cpe_"))}
        assert sorted(g) == sorted(w)
        assert ("order_perm" in g) == host_structure
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_one_train_step_with_host_structure_matches_jax():
    batch = ts._batch(seed=5)
    jcfg, cfg = _cfgs(POLICY_MODEL)
    jb_np = jstructure.attach_host_structure(
        copy.deepcopy(batch), jcfg, np.random.RandomState(3))
    pb = structure.attach_host_structure(copy.deepcopy(batch), cfg,
                                         np.random.RandomState(3))
    assert int(pb["order_perm"][0]) != 0     # not the z-order of the input
    assert "stem_nmap" in jb_np and "cpe_nmap1" in jb_np
    jb = {k: jnp.asarray(v) for k, v in jb_np.items()}

    model = SimplePolicyTPU(ptv3_cfg=dict(ts.PTV3, attn_impl="xla",
                                          conv_impl="xla"),
                            act_cfg=ts.ACT, variant="ca")
    key = jax.random.PRNGKey(0)
    plain = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda b: model.init(
        {"params": key, "dropout": key, "shuffle": key}, b,
        deterministic=True))(plain)
    variables = ts._perturb(jax.tree_util.tree_map(np.asarray,
                                                   dict(variables)))
    loss_fn = lambda p, b: jloss(p, b, ts.ACT, ts.LOSS)  # noqa: E731

    def compute(params):
        preds, mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jb,
            deterministic=False, rngs={"dropout": key, "shuffle": key},
            mutable=["batch_stats"])
        losses = loss_fn(preds, jb)
        return losses["total"], (losses, mutated)
    (_, (jlosses, mutated)), jgrads = jax.jit(jax.value_and_grad(
        compute, has_aux=True))(variables["params"])
    tx, _ = jbuild_optimizer(variables["params"], ts.TRAIN)
    state = TrainState.create(apply_fn=model.apply,
                              params=variables["params"], tx=tx,
                              batch_stats=variables["batch_stats"])
    new_state, step_losses = make_train_step(model, loss_fn, donate=False)(
        state, jb, key)

    port = build_model({"model_class": "SimplePolicyPTV3CA",
                        "ptv3_config": ts.PTV3, "action_config": ts.ACT},
                       device="cpu")
    port.load_state_dict(params_from_jax(variables), strict=True)
    opt, _ = build_optimizer(port, ts.TRAIN)
    rng = Randomness(0, perms=[])      # a redraw would find no permutation
    trainer = Trainer(port, lambda p, b: compute_loss(p, b, ts.ACT, ts.LOSS),
                      opt, rng)
    losses = trainer.step(batch_to_device(pb, "cpu"))
    assert rng.perms == []

    for k in jlosses:
        ts._close(losses[k], jlosses[k], k)
        ts._close(losses[k], step_losses[k], k)
    grads = params_from_jax({"params": jgrads})
    named = dict(port.named_parameters())
    scales, floor = ts._grad_scales(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(
            named[k].grad.numpy(), np.asarray(g), rtol=0,
            atol=ts.ATOL * max(scales[k], floor), err_msg=f"grad {k}")
    updated = params_from_jax({"params": new_state.params,
                               "batch_stats": new_state.batch_stats})
    ref_stats = params_from_jax({"params": {},
                                 "batch_stats": mutated["batch_stats"]})
    sd = port.state_dict()
    for k, v in updated.items():
        if k in grads and float(np.abs(np.asarray(grads[k])).max()) < 1e-6:
            assert float((sd[k] - v).abs().max()) <= 2 * ts.TRAIN[
                "learning_rate"], k
            continue
        ts._close(sd[k], v, k)
    for k, v in ref_stats.items():
        ts._close(sd[k], v, k)


def test_order_perm_skips_the_entry_sort_and_redraws():
    """Under order_perm the train-mode forward draws no permutation, and
    its sort0 is the identity (the batch is already in the frame)."""
    batch = structure.attach_host_structure(
        ts._batch(seed=6), _cfgs(POLICY_MODEL)[1], np.random.RandomState(0))
    port = build_model({"model_class": "SimplePolicyPTV3CA",
                        "ptv3_config": ts.PTV3, "action_config": ts.ACT},
                       device="cpu")
    port.train()
    rng = Randomness(0, perms=[])
    preds = port(batch_to_device(batch, "cpu"), rng=rng)
    N = batch["pc_fts"].shape[1]
    assert torch.equal(preds["sort0"], torch.arange(N).expand(2, N))
