"""PyTorch port vs the JAX package: one whole training step of the policy.

A tiny SimplePolicyPTV3CA (2 stages, narrow widths, dropout 0, orders
shuffled) with JAX-initialised, perturbed variables carried across by
convert.params_from_jax, one numpy batch, the same SFC order permutations
handed to both sides (jax.random.permutation is patched inside the test;
nothing in the JAX package changes). Compared with the JAX make_train_step:
the loss dict, every updated parameter and the batch-norm running
statistics within 1e-4 * max(1, |ref|) (fp32, other summation orders);
every parameter gradient within 1e-4 of its own leaf's largest |grad|,
floored at 1e-3 of the largest |grad| of all leaves (gradients are far
below 1, so a max(1, |ref|) bar would pass any value). The JAX side runs
its exact XLA paths; the
clouds hold duplicate voxels, which the port's conv input gradient
(ops/conv.py conv_input_grad) must handle exactly.

Then the port alone: three CPU steps on synthetic_reach with the release
dropout rates and a falling loss, and the training entry point on the CPU.
"""
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robot3dlotus_tpu.models.simple_policy import (SimplePolicyTPU,
                                                   compute_loss as jloss)
from robot3dlotus_tpu.train.optim import build_optimizer as jbuild_optimizer
from robot3dlotus_tpu.train.trainer import TrainState, make_train_step
from robot3dlotus_tpu_torch.configs import get_config
from robot3dlotus_tpu_torch.convert import params_from_jax
from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.models.layers import Randomness
from robot3dlotus_tpu_torch.models.simple_policy import compute_loss
from robot3dlotus_tpu_torch.train import train_simple_policy
from robot3dlotus_tpu_torch.train.driver import build_trainer
from robot3dlotus_tpu_torch.train.optim import build_optimizer
from robot3dlotus_tpu_torch.train.trainer import Trainer, batch_to_device

ATOL = 1e-4
RELEASE_CFG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "robot3dlotus_tpu_torch", "configs", "rlbench", "simple_policy_ptv3.yaml")
PTV3 = {
    "in_channels": 7, "orders": ["z", "z-trans", "hilbert", "hilbert-trans"],
    "stride": [2], "enc_depths": [1, 1], "enc_channels": [16, 32],
    "enc_num_head": [2, 2], "enc_patch_size": [16, 16], "dec_depths": [1],
    "dec_channels": [16], "dec_num_head": [2], "dec_patch_size": [16],
    "qkv_bias": True, "qk_norm": True, "attn_drop": 0.0, "proj_drop": 0.0,
    "drop_path": 0.0, "shuffle_orders": True, "serial_depth": 6,
    "stem_kernel": 5, "stage_caps": [128, 128],
}
ACT = {
    "voxel_size": 0.01, "context_channels": 32, "txt_ft_size": 64,
    "use_ee_pose": False, "use_step_id": False, "reduce": "max",
    "dim_actions": 7, "pos_pred_type": "heatmap_disc",
    "pos_heatmap_temp": 0.1, "rot_pred_type": "euler_disc", "dropout": 0.0,
    "pos_bins": 5, "pos_bin_size": 0.01, "best_disc_pos": "max",
    "euler_resolution": 5, "pos_heatmap_type": "dist",
}
LOSS = {"pos_weight": 1.0, "rot_weight": 1.0}
TRAIN = {"optim": "adamw", "learning_rate": 1e-3, "betas": [0.9, 0.98],
         "weight_decay": 0.05, "grad_norm": 10, "lr_sched": "cosine",
         "warmup_steps": 1, "num_train_steps": 100}
# stage 0, then after the pooling: [z, z-trans, hilbert, hilbert-trans]
# reordered, so both stages attend along a curve other than z
PERMS = [[2, 0, 3, 1], [1, 3, 0, 2]]


def _batch(seed=0, B=2, N=128, T=4, span=12):
    """Grid offsets are voxel centres, except the per-axis minimum, which
    sits on the voxel edge that compute_grid_coord subtracts, so every
    floor is far from an integer. Ten points of each cloud repeat the
    coordinates of ten others: duplicate voxels, whose links the conv's
    input gradient must still invert exactly."""
    rng = np.random.RandomState(seed)
    counts = np.array([N, N - 27][:B], np.int32)
    mask = np.arange(N)[None] < counts[:, None]
    pc = np.zeros((B, N, 7), np.float32)
    for b in range(B):
        flat = rng.choice(span ** 3, counts[b], replace=False)
        gc = np.stack(np.unravel_index(flat, (span,) * 3), -1)
        gc = gc - gc.min(0)
        pc[b, :counts[b], :3] = np.where(gc > 0, gc + 0.5, 0.0) * 0.01 - 0.05
        pc[b, :counts[b], 3:] = rng.uniform(-1, 1, (counts[b], 4))
        pc[b, 90:100, :3] = pc[b, 10:20, :3]
    gt = np.zeros((B, 7), np.float32)
    gt[:, :3] = pc[:, 7, :3] + 0.004
    gt[:, 3:6] = rng.randint(0, 72, (B, 3))
    gt[:, 6] = [0, 1]
    tmask = np.ones((B, T), bool)
    tmask[0, 3:] = False
    return {"pc_fts": pc, "pc_mask": mask, "pc_counts": counts,
            "txt_embeds": rng.randn(B, T, 64).astype(np.float32),
            "txt_mask": tmask, "gt_actions": gt,
            "pc_robot_mask": (rng.rand(B, N) < 0.1) & mask,
            "batch_valid": np.ones(B, bool)}


def _perturb(variables, seed=1):
    """Random biases, norm scales and running statistics on top of the JAX
    init, so every leaf is exercised."""
    rng = np.random.RandomState(seed)

    def walk(tree, stats):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, stats)
                continue
            a = np.asarray(v, np.float32)
            if stats and k == "var":
                a = a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            else:
                a = a + (rng.randn(*a.shape) * 0.1).astype(np.float32)
            out[k] = a
        return out
    return {"params": walk(variables["params"], False),
            "batch_stats": walk(variables["batch_stats"], True)}


def _close(got, want, name):
    want = np.asarray(want)
    tol = ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0,
                               err_msg=name)


def _grad_scales(grads):
    """(scale of each leaf, floor): the reach of the gradient check. Every
    leaf is held relative to its own largest |grad|, or, below the floor,
    to the floor; only leaves whose gradient is zero up to rounding (a bias
    in front of a norm, the key norm's bias) may sit below it."""
    scales = {k: float(np.abs(np.asarray(g)).max()) for k, g in grads.items()}
    gmax = max(scales.values())
    floor = 1e-3 * gmax
    below = {k: s for k, s in scales.items() if 1e-6 * gmax <= s < floor}
    assert not below, f"gradients held only to the floor {floor}: {below}"
    return scales, floor


def test_one_train_step_matches_jax(monkeypatch):
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = SimplePolicyTPU(ptv3_cfg=dict(PTV3, attn_impl="xla",
                                          conv_impl="xla"),
                            act_cfg=ACT, variant="ca")
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b: model.init(
        {"params": key, "dropout": key, "shuffle": key}, b,
        deterministic=True))(jb)
    variables = _perturb(jax.tree_util.tree_map(np.asarray, dict(variables)))

    calls = []

    def permutation(rng, n):       # stands in for the shuffle draws
        calls.append(n)
        return jnp.asarray(PERMS[(len(calls) - 1) % len(PERMS)])
    monkeypatch.setattr(jax.random, "permutation", permutation)

    loss_fn = lambda p, b: jloss(p, b, ACT, LOSS)  # noqa: E731

    def compute(params):
        preds, mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jb,
            deterministic=False, rngs={"dropout": key, "shuffle": key},
            mutable=["batch_stats"])
        losses = loss_fn(preds, jb)
        return losses["total"], (losses, mutated)
    (_, (jlosses, mutated)), jgrads = jax.jit(jax.value_and_grad(
        compute, has_aux=True))(variables["params"])
    tx, _ = jbuild_optimizer(variables["params"], TRAIN)
    state = TrainState.create(apply_fn=model.apply,
                              params=variables["params"], tx=tx,
                              batch_stats=variables["batch_stats"])
    new_state, step_losses = make_train_step(model, loss_fn, donate=False)(
        state, jb, key)
    assert calls == [4] * 4      # stage 0 and the pooling, in two traces

    port = build_model({"model_class": "SimplePolicyPTV3CA",
                        "ptv3_config": PTV3, "action_config": ACT},
                       device="cpu")
    port.load_state_dict(params_from_jax(variables), strict=True)
    opt, _ = build_optimizer(port, TRAIN)
    trainer = Trainer(port, lambda p, b: compute_loss(p, b, ACT, LOSS), opt,
                      Randomness(0, perms=PERMS))
    losses = trainer.step(batch_to_device(batch, "cpu"))

    assert set(losses) == set(jlosses)
    for k in jlosses:
        _close(losses[k], jlosses[k], k)
        _close(losses[k], step_losses[k], k)
    grads = params_from_jax({"params": jgrads})
    named = dict(port.named_parameters())
    assert set(grads) == set(named)
    scales, floor = _grad_scales(grads)
    print(f"gradient check: {len(scales)} leaves, largest |grad| "
          f"{max(scales.values()):.3g}, floor {floor:.3g}, smallest leaf "
          f"held above it {min(s for s in scales.values() if s >= floor):.3g}"
          f", {sum(s < floor for s in scales.values())} leaves zero up to "
          "rounding")
    for k, g in grads.items():
        np.testing.assert_allclose(
            named[k].grad.numpy(), np.asarray(g), rtol=0,
            atol=ATOL * max(scales[k], floor), err_msg=f"grad {k}")
    updated = params_from_jax({"params": new_state.params,
                               "batch_stats": new_state.batch_stats})
    ref_stats = params_from_jax({"params": {},
                                 "batch_stats": mutated["batch_stats"]})
    sd = port.state_dict()
    assert set(updated) == set(sd)
    for k, v in updated.items():
        if k in grads and float(np.abs(np.asarray(grads[k])).max()) < 1e-6:
            # a bias in front of a batch norm (or a segment max feeding
            # one) has a zero gradient up to rounding, which Adam's
            # normalisation scales up to ~lr on either side: bound the
            # step instead
            assert float((sd[k] - v).abs().max()) <= 2 * TRAIN[
                "learning_rate"], k
            continue
        _close(sd[k], v, k)
    for k, v in ref_stats.items():
        _close(sd[k], v, k)


def _tiny_release_config(**train):
    """The release YAML at tiny width (what README.md shows for a CPU
    run), on the learnable synthetic store."""
    opts = ["TRAIN_DATASET.data_dir", "synthetic_reach",
            "TRAIN_DATASET.instr_embed_file", "None",
            "TRAIN_DATASET.taskvar_instr_file", "None",
            "TRAIN_DATASET.taskvar_file", "None",
            "TRAIN_DATASET.num_points", "256",
            "TRAIN.train_batch_size", "4",
            "MODEL.ptv3_config.enc_channels", "[16,16,32,32,32]",
            "MODEL.ptv3_config.dec_channels", "[16,16,32,32]",
            "MODEL.ptv3_config.enc_num_head", "[2,2,2,2,2]",
            "MODEL.ptv3_config.dec_num_head", "[2,2,2,2]",
            "MODEL.ptv3_config.enc_patch_size", "[16,16,16,16,16]",
            "MODEL.ptv3_config.dec_patch_size", "[16,16,16,16]",
            "MODEL.ptv3_config.stage_caps", "[256,256,128,64,32]"]
    for k, v in train.items():
        opts += [f"TRAIN.{k}", str(v)]
    return get_config(RELEASE_CFG, opts)


def test_three_cpu_steps_on_synthetic_reach_lower_the_loss():
    """The release dropout rates, attention dropout and order shuffling on
    the CPU path: three steps on one synthetic_reach batch give finite
    losses, the last below the first, and move the BN statistics."""
    config = _tiny_release_config(learning_rate=3e-3, warmup_steps=1)
    trainer, batches, _ = build_trainer(config, train_simple_policy.SPEC,
                                        device="cpu")
    batch = batch_to_device(next(batches), "cpu")
    stats = trainer.model.ptv3_model.embedding_norm.norm.running_mean.clone()
    totals = []
    for _ in range(3):
        losses = trainer.step(batch)
        assert all(np.isfinite(float(v)) for v in losses.values())
        totals.append(float(losses["total"]))
    assert totals[-1] < totals[0], totals
    assert not torch.equal(
        stats, trainer.model.ptv3_model.embedding_norm.norm.running_mean)


def test_training_entry_point_runs_on_cpu(caplog):
    config = _tiny_release_config(num_train_steps=2, log_steps=1)
    with caplog.at_level("INFO", logger="robot3dlotus_tpu_torch.train"):
        trainer = train_simple_policy.main(config, device="cpu")
    assert trainer.optimizer.count == 2
    assert "step 2:" in caplog.text
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_simple_policy.main(config)
