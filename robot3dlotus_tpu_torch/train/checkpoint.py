"""Checkpoints in the JAX package's layout (port of
robot3dlotus_tpu/train/checkpoint.py).

A run directory holds, in both packages:
  logs/training_config.yaml   — the resolved config (serving reloads it)
  ckpts/model_step_{N}.msgpack     — {params, batch_stats}, flax names
  ckpts/train_state_latest.msgpack — {step: np.int64, opt_state}
written with flax's msgpack layout (train.serialization), so a directory
either package wrote resumes and serves in the other. opt_state is the
JAX build_optimizer's state of TRAIN.optim: {count: int32 0-d, mu: (Tpad,),
nu: (Tpad,)} for the fused AdamW, the optax chain of per-leaf trees for
the others, inside optax.MultiSteps' {mini_step, gradient_step,
inner_opt_state, acc_grads, skip_state} under gradient accumulation. The
trees go through convert.params_to_jax / params_from_jax and
opt_state_to_jax / opt_state_from_jax. Loads go onto the model's device and raise on a
missing key or a shape that differs: nothing keeps a seeded init quietly.
"""
from __future__ import annotations

import logging
import os
import re

import numpy as np

from ..convert import (opt_state_from_jax, opt_state_to_jax,
                       params_from_jax, params_to_jax)
from . import serialization
from .torch_convert import flatten_tree, load_torch_checkpoint, unflatten_tree

LOGGER = logging.getLogger("robot3dlotus_tpu_torch.train")
LATEST = "train_state_latest.msgpack"


def save_training_meta(output_dir, config):
    os.makedirs(os.path.join(output_dir, "logs"), exist_ok=True)
    os.makedirs(os.path.join(output_dir, "ckpts"), exist_ok=True)
    with open(os.path.join(output_dir, "logs", "training_config.yaml"),
              "w") as f:
        config.dump(f)


class ModelSaver:
    def __init__(self, output_dir):
        self.ckpt_dir = os.path.join(output_dir, "ckpts")
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def save(self, model, step, optimizer=None):
        """Writes model_step_{step}.msgpack and, given the optimizer,
        train_state_latest.msgpack; returns the model file's path."""
        path = os.path.join(self.ckpt_dir, f"model_step_{step}.msgpack")
        serialization.save(path, params_to_jax(model))
        if optimizer is not None:
            serialization.save(
                os.path.join(self.ckpt_dir, LATEST),
                {"step": np.int64(step),
                 "opt_state": opt_state_to_jax(optimizer, model)})
        return path


def find_resume_step(output_dir):
    ckpt_dir = os.path.join(output_dir, "ckpts")
    if not os.path.exists(os.path.join(ckpt_dir, LATEST)):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"model_step_(\d+)\.msgpack$", f))]
    return max(steps) if steps else None


def _on_model(state_dict, model, path):
    """state_dict (CPU tensors) checked against the model's keys and
    shapes and moved to its device."""
    own = model.state_dict()
    missing, extra = sorted(set(own) - set(state_dict)), \
        sorted(set(state_dict) - set(own))
    if missing or extra:
        raise KeyError(f"{path}: {len(missing)} model tensors missing "
                       f"{missing[:5]}, {len(extra)} not in the model "
                       f"{extra[:5]}")
    for k, v in state_dict.items():
        if v.shape != own[k].shape:
            raise ValueError(f"{path}: {k} shape {tuple(v.shape)} vs model "
                             f"{tuple(own[k].shape)}")
    return {k: v.to(own[k].device, own[k].dtype)
            for k, v in state_dict.items()}


def load_model_ckpt(path, model):
    """A model_step_{N}.msgpack -> the model's state_dict on its device."""
    tree = serialization.load(path)
    return _on_model(params_from_jax(tree), model, path)


def _encoder_leaf(key):
    return "/ptv3_model/" in key and not re.search(r"/dec\d+_", key)


def warm_start_variables(model, path, model_cfg=None, encoder_only=False,
                         strict=False):
    """Shape-filtered partial load into the model, in place (JAX
    warm_start_variables): a checkpoint tensor loads where the model has
    the same name and shape, everything else keeps its fresh init. With
    `encoder_only`, only backbone encoder tensors load (ptv3_model/*
    minus dec{s}_*); with `strict`, every model tensor (every encoder
    tensor under encoder_only) must be covered. Accepts .msgpack or an
    upstream-layout torch .pt (needs model_cfg). Returns (n_loaded,
    n_skipped)."""
    if str(path).endswith((".pt", ".pth")):
        if model_cfg is None:
            raise ValueError("torch checkpoints need model_cfg")
        params_tree, bstats_tree, _, _ = load_torch_checkpoint(
            path, model_cfg)
        src = {"params": params_tree, "batch_stats": bstats_tree}
    else:
        src = serialization.load(path)
    src_flat = flatten_tree(src)
    dst_flat = flatten_tree(params_to_jax(model))
    n_loaded = n_skipped = 0
    loaded_keys = set()
    for k, v in src_flat.items():
        keep = (not encoder_only) or _encoder_leaf(k)
        if keep and k in dst_flat and v.shape == dst_flat[k].shape:
            dst_flat[k] = v.astype(dst_flat[k].dtype)
            loaded_keys.add(k)
            n_loaded += 1
        else:
            n_skipped += 1
    if strict:
        want = {k for k in dst_flat if (not encoder_only) or _encoder_leaf(k)}
        uncovered = sorted(want - loaded_keys)
        if uncovered:
            raise ValueError(
                f"checkpoint_strict_load: {path} leaves {len(uncovered)} "
                f"model tensors uninitialized, e.g. {uncovered[:5]}")
    model.load_state_dict(
        _on_model(params_from_jax(unflatten_tree(dst_flat)), model, path),
        strict=True)
    return n_loaded, n_skipped


def load_any_model_ckpt(path, model, model_cfg=None):
    """A checkpoint -> the model's state_dict on its device, by format: a
    .msgpack of either package, or an upstream-layout torch .pt/.pth
    converted by torch_convert (needs the MODEL config). A .pt that leaves
    a model tensor uncovered, or holds one the model lacks, raises."""
    if not str(path).endswith((".pt", ".pth")):
        return load_model_ckpt(path, model)
    if model_cfg is None:
        raise ValueError("torch checkpoints need model_cfg for conversion")
    params_tree, bstats_tree, missing, unexpected = load_torch_checkpoint(
        path, model_cfg)
    if missing or unexpected:
        raise KeyError(f"torch checkpoint {path}: {len(missing)} missing "
                       f"{missing[:3]}, {len(unexpected)} unexpected "
                       f"{unexpected[:3]}")
    return _on_model(params_from_jax({"params": params_tree,
                                      "batch_stats": bstats_tree}),
                     model, path)


def load_train_state_latest(output_dir):
    """-> {step, opt_state} of ckpts/train_state_latest.msgpack (the
    opt_state is checked against the optimizer when it is loaded)."""
    latest = serialization.load(os.path.join(output_dir, "ckpts", LATEST))
    if set(latest) != {"step", "opt_state"}:
        raise KeyError(f"{output_dir}: {LATEST} is not a train state "
                       "{step, opt_state}")
    return latest


def resume_or_init(trainer, output_dir):
    """Loads the latest model and optimizer state of `output_dir` into the
    trainer (model, optimizer, step) and returns the step; 0 when there is
    nothing to resume."""
    step = find_resume_step(output_dir)
    if step is None:
        return 0
    model = trainer.model
    path = os.path.join(output_dir, "ckpts", f"model_step_{step}.msgpack")
    state_dict = load_model_ckpt(path, model)
    latest = load_train_state_latest(output_dir)
    if int(latest["step"]) != step:
        raise ValueError(f"{output_dir}: {LATEST} is at step "
                         f"{int(latest['step'])}, the newest model at {step}")
    model.load_state_dict(state_dict, strict=True)
    opt_state_from_jax(latest["opt_state"], trainer.optimizer, model)
    trainer.global_step = step
    return step
