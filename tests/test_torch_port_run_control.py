"""The port's run control and serving from checkpoints, against the JAX
package where it has a counterpart.

Run control: train_simple_policy.main on the CPU with validation, a
SIGUSR1 sent to the process itself at step 3 (a save, a return, the
handler put back), then a second main that resumes there; metrics.jsonl
holds the JAX driver's train and val_ keys. A warm start in main.

Serving: Actioner(checkpoint=...) and MotionPlannerEngine(checkpoint=...)
from JAX-written, port-written and upstream .pt files equal the same
weights carried across by params_from_jax.
"""
import json
import os
import signal

import numpy as np
import pytest
import torch
import yaml
import jax
import jax.numpy as jnp
from flax import serialization as flax_ser

from robot3dlotus_tpu.configs import get_config as jget_config
from robot3dlotus_tpu.models.simple_policy import (SimplePolicyTPU,
                                                   compute_loss as jloss)
from robot3dlotus_tpu.train import checkpoint as jckpt
from robot3dlotus_tpu.train import torch_convert as jtc
from robot3dlotus_tpu.train import train_simple_policy as jtsp
from robot3dlotus_tpu_torch.configs import get_config
from robot3dlotus_tpu_torch.convert import params_from_jax
from robot3dlotus_tpu_torch.eval import robot_pipeline as pipe
from robot3dlotus_tpu_torch.eval.actioner import Actioner
from robot3dlotus_tpu_torch.eval.synthetic_obs import synthetic_observation
from robot3dlotus_tpu_torch.train import checkpoint as ckpt
from robot3dlotus_tpu_torch.train import driver, train_simple_policy
import test_torch_port_motion_planner as tmp_mp
import test_torch_port_train_step as tmp_ts
from test_torch_port_validation import POLICY, _policy_variables


# ------------------------------------------------------------ run control --

def _run_config(tmp_path, **train):
    opts = ["output_dir", str(tmp_path / "run"),
            "TRAIN_DATASET.data_dir", "synthetic_reach",
            "TRAIN_DATASET.instr_embed_file", "None",
            "TRAIN_DATASET.taskvar_instr_file", "None",
            "TRAIN_DATASET.taskvar_file", "None",
            "TRAIN_DATASET.num_points", "128",
            "VAL_DATASET.use_val", "True",
            "VAL_DATASET.data_dir", "synthetic_reach1",
            "VAL_DATASET.instr_embed_file", "None",
            "VAL_DATASET.taskvar_instr_file", "None",
            "VAL_DATASET.taskvar_file", "None",
            "VAL_DATASET.num_points", "128",
            "TRAIN.train_batch_size", "4", "TRAIN.val_batch_size", "6",
            "TRAIN.num_train_steps", "3", "TRAIN.log_steps", "1",
            "TRAIN.save_steps", "2", "TRAIN.val_steps", "2",
            "MODEL.ptv3_config.enc_channels", "[16,16,32,32,32]",
            "MODEL.ptv3_config.dec_channels", "[16,16,32,32]",
            "MODEL.ptv3_config.enc_num_head", "[2,2,2,2,2]",
            "MODEL.ptv3_config.dec_num_head", "[2,2,2,2]",
            "MODEL.ptv3_config.enc_patch_size", "[16,16,16,16,16]",
            "MODEL.ptv3_config.dec_patch_size", "[16,16,16,16]",
            "MODEL.ptv3_config.stage_caps", "[128,128,64,32,16]"]
    for k, v in train.items():
        opts += [f"TRAIN.{k}", str(v)]
    return get_config(tmp_ts.RELEASE_CFG, opts)


def test_preemption_saves_and_next_main_resumes(tmp_path, monkeypatch,
                                                caplog):
    """SIGUSR1 to this process after step 1: the loop saves step 1 at the
    next step boundary and returns, leaving the previous handler in place;
    the next main logs a resume at 1, saves and validates at 2 (save_steps,
    val_steps) and at its end, 3.
    metrics.jsonl: train records with the JAX loss dict's keys, lr and
    samples_per_sec; val_ records with the JAX _run_validation names."""
    config = _run_config(tmp_path)
    run = config.output_dir
    before = signal.getsignal(signal.SIGUSR1)
    real_step = driver.Trainer.step

    def step(self, batch):
        out = real_step(self, batch)
        if self.global_step == 1:
            os.kill(os.getpid(), signal.SIGUSR1)
        return out
    monkeypatch.setattr(driver.Trainer, "step", step)
    with caplog.at_level("INFO", logger="robot3dlotus_tpu_torch.train"):
        first = train_simple_policy.main(config, device="cpu")
    assert first.global_step == 1 and first.optimizer.count == 1
    assert "preemption signal" in caplog.text
    assert signal.getsignal(signal.SIGUSR1) is before
    ckpts = sorted(os.listdir(os.path.join(run, "ckpts")))
    assert ckpts == ["model_step_1.msgpack", "train_state_latest.msgpack"]
    assert ckpt.find_resume_step(run) == 1
    monkeypatch.setattr(driver.Trainer, "step", real_step)
    caplog.clear()
    with caplog.at_level("INFO", logger="robot3dlotus_tpu_torch.train"):
        second = train_simple_policy.main(config, device="cpu")
    assert "resumed at step 1" in caplog.text
    assert second.global_step == 3 and second.optimizer.count == 3
    assert sorted(os.listdir(os.path.join(run, "ckpts")))[:3] == [
        "model_step_1.msgpack", "model_step_2.msgpack",
        "model_step_3.msgpack"]
    with open(os.path.join(run, "logs", "training_config.yaml")) as f:
        assert yaml.safe_load(f)["TRAIN"]["save_steps"] == 2
    assert os.path.exists(os.path.join(run, "logs", "log.txt"))

    with open(os.path.join(run, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if "total" in r]
    val = [r for r in recs if "val_total_loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3]
    assert [r["step"] for r in val] == [2, 3]
    jkeys = _jax_loss_keys()
    for r in train:
        assert set(r) == jkeys | {"lr", "samples_per_sec", "step", "time"}
    jval = {k if k.endswith("loss") else (         # the JAX driver's names
        "total_loss" if k == "total" else f"{k}_loss") for k in jkeys}
    jval |= set(jtsp.SPEC.val_accuracy(
        np.zeros((2, 8), np.float32), {"batch_valid": np.ones(2, bool),
                                       "gt_actions": np.zeros((2, 8))}))
    for r in val:
        assert set(r) == {f"val_{k}" for k in jval} | {"step", "time"}
        assert all(np.isfinite(v) for v in r.values())


def test_training_config_round_trips(tmp_path):
    """logs/training_config.yaml, which serving reloads, reads back the
    same in both packages, whichever wrote it."""
    config = _run_config(tmp_path)
    ckpt.save_training_meta(str(tmp_path / "port"), config)
    jckpt.save_training_meta(str(tmp_path / "jax"),
                             jget_config(tmp_ts.RELEASE_CFG))
    for d in ("port", "jax"):
        path = str(tmp_path / d / "logs" / "training_config.yaml")
        assert get_config(path).to_dict() == jget_config(path).to_dict()
    assert get_config(str(tmp_path / "port" / "logs" /
                          "training_config.yaml")).to_dict() == \
        config.to_dict()


def _jax_loss_keys():
    """The keys of the JAX policy loss dict (the JAX driver's train metric
    names), from an abstract evaluation: traced, not compiled."""
    jmodel = SimplePolicyTPU(ptv3_cfg=dict(tmp_ts.PTV3, attn_impl="xla",
                                           conv_impl="xla"),
                             act_cfg=tmp_ts.ACT, variant="ca")
    jb = {k: jnp.asarray(v) for k, v in tmp_ts._batch().items()}
    key = jax.random.PRNGKey(0)

    def losses(b):
        variables = jmodel.init({"params": key, "dropout": key,
                                 "shuffle": key}, b, deterministic=True)
        preds = jmodel.apply(variables, b, deterministic=True)
        return jloss(preds, b, tmp_ts.ACT, tmp_ts.LOSS)
    return set(jax.eval_shape(losses, jb))


def test_warm_start_from_a_run_in_main(tmp_path, caplog):
    """`checkpoint` warm-starts a fresh run (no resume in its output_dir):
    strict, so every tensor of the model loads; the run then trains."""
    config = _run_config(tmp_path, num_train_steps=2, val_steps=100)
    train_simple_policy.main(config, device="cpu")
    src = os.path.join(config.output_dir, "ckpts", "model_step_2.msgpack")
    warm = _run_config(tmp_path / "warm", num_train_steps=1, val_steps=100)
    warm.defrost()
    warm.checkpoint, warm.checkpoint_strict_load = src, True
    warm.freeze()
    with caplog.at_level("INFO", logger="robot3dlotus_tpu_torch.train"):
        trainer = train_simple_policy.main(warm, device="cpu")
    assert "warm start from" in caplog.text and "0 skipped" in caplog.text
    assert trainer.global_step == 1


# --------------------------------------------------------------- serving --

def test_actioner_serves_checkpoints(tmp_path):
    """Actioner(checkpoint=...) from a JAX model file, a port model file
    and an upstream .pt: state bit-equal to params_from_jax of the JAX
    weights, and the same action as that state loaded by hand."""
    _, variables = _policy_variables()
    model = dict(POLICY, ptv3_config=dict(tmp_ts.PTV3,
                                          stage_caps=[128] * 2))
    cfg_path = str(tmp_path / "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"TRAIN_DATASET": {"num_points": 128},
                        "MODEL": model}, f)
    jfile = str(tmp_path / "jax.msgpack")
    with open(jfile, "wb") as f:
        f.write(flax_ser.to_bytes(variables))
    pt = str(tmp_path / "model.pt")
    jtc.save_torch_checkpoint(pt, variables["params"],
                              variables["batch_stats"], model)
    ref = Actioner(cfg_path, device="cpu")
    want_sd = params_from_jax(variables)
    ref.model.load_state_dict(want_sd, strict=True)
    pfile = ckpt.ModelSaver(str(tmp_path / "run")).save(ref.model, 1)
    obs = synthetic_observation(3, cameras=1, height=32, width=32)
    req = dict(task_str="close_jar", variation=0, obs_state_dict=obs)
    ref.rng = np.random.default_rng(0)
    want = ref.predict(**req)["action"]
    for path in (jfile, pfile, pt):
        a = Actioner(cfg_path, checkpoint=path, device="cpu")
        sd = a.model.state_dict()
        for k, v in want_sd.items():
            assert torch.equal(sd[k], v), (path, k)
        a.rng = np.random.default_rng(0)
        np.testing.assert_array_equal(a.predict(**req)["action"], want)


def test_motion_planner_engine_serves_checkpoints(tmp_path):
    """MotionPlannerEngine(checkpoint=...) from a JAX and a port model file
    and an upstream .pt: bit-equal state, and the same trajectory as the
    JAX weights loaded by hand; a missing file raises."""
    model = dict(tmp_mp.MP_MODEL, ptv3_config=dict(tmp_mp.PTV3,
                                                   stage_caps=[256, 256]))
    cfg_path = str(tmp_path / "mp.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"TRAIN_DATASET": {"num_points": 256},
                        "MODEL": model}, f)
    variables = tmp_mp.jax_variables(tmp_mp.mp_batch())
    jfile = str(tmp_path / "mp.msgpack")
    with open(jfile, "wb") as f:
        f.write(flax_ser.to_bytes(variables))
    pt = str(tmp_path / "mp.pt")
    jtc.save_torch_checkpoint(pt, variables["params"],
                              variables["batch_stats"], model)
    ref = pipe.MotionPlannerEngine(cfg_path, device="cpu")
    want_sd = params_from_jax(variables)
    ref.model.load_state_dict(want_sd, strict=True)
    pfile = ckpt.ModelSaver(str(tmp_path / "run")).save(ref.model, 1)
    rng = np.random.RandomState(0)
    n = 200
    args = (rng.randn(n, 4).astype(np.float32), rng.randint(0, 4, n),
            rng.randn(3, 64).astype(np.float32), np.zeros(8, np.float32),
            np.zeros(3), 1.0, 0.0)
    want = ref.predict(*args)
    for path in (jfile, pfile, pt):
        e = pipe.MotionPlannerEngine(cfg_path, checkpoint=path, device="cpu")
        sd = e.model.state_dict()
        for k, v in want_sd.items():
            assert torch.equal(sd[k], v), (path, k)
        np.testing.assert_array_equal(e.predict(*args), want)
    with pytest.raises(FileNotFoundError):
        pipe.MotionPlannerEngine(cfg_path, checkpoint=str(tmp_path / "no.pt"),
                                 device="cpu")
