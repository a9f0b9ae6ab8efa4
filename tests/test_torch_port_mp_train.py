"""PyTorch port vs the JAX package: one whole training step of the
3D-LOTUS++ motion planner, then the port's training entry point alone.

The tiny MotionPlannerPTV3CA of test_torch_port_motion_planner.py (2
stages, the k=5 stem with its categorical label channel, dropout 0,
orders shuffled), JAX-initialised and perturbed variables carried across
by convert.params_from_jax, one numpy batch, the same SFC order
permutations handed to both sides (jax.random.permutation is patched
inside the test; nothing in the JAX package changes). Compared with the
JAX make_train_step and compute_mp_loss: the loss dict, every updated
parameter and the batch-norm running statistics within 1e-4 * max(1,
|ref|); every parameter gradient (the label and trajectory-step
embeddings and the stem weight included) within 1e-4 of its own leaf's
largest |grad|, floored at 1e-3 of the largest |grad| of all leaves.
"""
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robot3dlotus_tpu.train.optim import build_optimizer as jbuild_optimizer
from robot3dlotus_tpu.train.trainer import TrainState, make_train_step
from robot3dlotus_tpu.models.motion_planner import compute_mp_loss as jloss
from robot3dlotus_tpu_torch.convert import params_from_jax
from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.models.layers import Randomness
from robot3dlotus_tpu_torch.models.motion_planner import compute_mp_loss
from robot3dlotus_tpu_torch.train import train_motion_planner
from robot3dlotus_tpu_torch.train.optim import build_optimizer
from robot3dlotus_tpu_torch.train.trainer import Trainer, batch_to_device
from test_torch_port_motion_planner import (ACT, LOSS, MP_MODEL, jax_model,
                                            jax_variables, mp_batch)

ATOL = 1e-4
RELEASE_CFG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "robot3dlotus_tpu_torch", "configs", "rlbench", "motion_planner_ptv3.yaml")
TRAIN = {"optim": "adamw", "learning_rate": 1e-3, "betas": [0.9, 0.98],
         "weight_decay": 0.05, "grad_norm": 10, "lr_sched": "cosine",
         "warmup_steps": 1, "num_train_steps": 100}
# stage 0, then after the pooling
PERMS = [[3, 1, 0, 2], [1, 2, 3, 0]]


def _close(got, want, name):
    want = np.asarray(want)
    tol = ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0,
                               err_msg=name)


def test_one_mp_train_step_matches_jax(monkeypatch):
    batch = mp_batch(seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax_variables(batch)
    calls = []

    def permutation(rng, n):       # stands in for the shuffle draws
        calls.append(n)
        return jnp.asarray(PERMS[(len(calls) - 1) % len(PERMS)])
    monkeypatch.setattr(jax.random, "permutation", permutation)

    model = jax_model()
    key = jax.random.PRNGKey(0)
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

    port = build_model(MP_MODEL, device="cpu")
    port.load_state_dict(params_from_jax(variables), strict=True)
    opt, _ = build_optimizer(port, TRAIN)
    trainer = Trainer(port, lambda p, b: compute_mp_loss(p, b, ACT, LOSS),
                      opt, Randomness(0, perms=PERMS))
    losses = trainer.step(batch_to_device(batch, "cpu"))

    assert set(losses) == set(jlosses)
    for k in jlosses:
        _close(losses[k], jlosses[k], k)
        _close(losses[k], step_losses[k], k)
    grads = params_from_jax({"params": jgrads})
    named = dict(port.named_parameters())
    assert set(grads) == set(named)
    scales = {k: float(np.abs(np.asarray(g)).max()) for k, g in grads.items()}
    floor = 1e-3 * max(scales.values())
    print(f"gradient check: {len(scales)} leaves, largest |grad| "
          f"{max(scales.values()):.3g}, floor {floor:.3g}, "
          f"{sum(s < floor for s in scales.values())} leaves below it")
    for k in ("pc_label_embedding.weight",
              "act_proj_head.traj_embedding.weight",
              "ptv3_model.embedding_stem_conv.weight"):
        assert scales[k] >= floor, k
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
        if k in grads and scales[k] < 1e-6:
            # a bias in front of a batch norm has a zero gradient up to
            # rounding, which Adam scales up to ~lr: bound the step
            assert float((sd[k] - v).abs().max()) <= 2 * TRAIN[
                "learning_rate"], k
            continue
        _close(sd[k], v, k)
    for k, v in ref_stats.items():
        _close(sd[k], v, k)


def _tiny_release_argv(*extra):
    """The release YAML at tiny width on the synthetic motion store (what
    README.md shows for a CPU run)."""
    return ["--exp-config", RELEASE_CFG, *extra,
            "TRAIN_DATASET.data_dir", "synthetic_motion",
            "TRAIN_DATASET.action_embed_file", "None",
            "TRAIN_DATASET.taskvar_file", "None",
            "TRAIN_DATASET.num_points", "256",
            "TRAIN.train_batch_size", "4",
            "TRAIN.num_train_steps", "3", "TRAIN.log_steps", "1",
            "MODEL.ptv3_config.enc_channels", "[16,16,32,32,32]",
            "MODEL.ptv3_config.dec_channels", "[16,16,32,32]",
            "MODEL.ptv3_config.enc_num_head", "[2,2,2,2,2]",
            "MODEL.ptv3_config.dec_num_head", "[2,2,2,2]",
            "MODEL.ptv3_config.enc_patch_size", "[16,16,16,16,16]",
            "MODEL.ptv3_config.dec_patch_size", "[16,16,16,16]",
            "MODEL.ptv3_config.stage_caps", "[256,256,128,64,32]"]


def test_motion_planner_entry_point_runs_on_cpu(caplog, tmp_path):
    """train_motion_planner.main --device cpu: three steps with the release
    dropout rates, attention dropout and order shuffling; every logged loss
    finite."""
    config, device = train_motion_planner.build_args(
        _tiny_release_argv("--device", "cpu") + ["output_dir", str(tmp_path)])
    assert device == "cpu"
    with caplog.at_level("INFO", logger="robot3dlotus_tpu_torch.train"):
        trainer = train_motion_planner.main(config, device=device)
    assert trainer.optimizer.count == 3
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("step ")]
    assert len(lines) == 3
    for line in lines:
        for kv in line.split(": ", 1)[1].split(", "):
            assert np.isfinite(float(kv.split("=")[1])), line
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_motion_planner.main(
                *train_motion_planner.build_args(_tiny_release_argv()))
