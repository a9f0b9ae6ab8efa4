"""The train and validation steps (port of robot3dlotus_tpu/train/trainer.py
`make_train_step`, `make_val_step` and `RunningMeter`).

One step: a train-mode forward (batch-statistics norms, which update their
running statistics in place; dropout, attention dropout and order
shuffling drawn from the trainer's Randomness, reseeded from (seed, step)
as the JAX step folds in state.step), the loss, the backward (every kernel
on the path has a hand-written backward) and the AdamW update.

Training runs in fp32 only: under ptv3_config compute_dtype 'bfloat16'
the trainers refuse (refuse_bf16_training), since the backward kernels
have no bf16 path yet; a fp32 checkpoint serves at bf16.
"""
from __future__ import annotations

import torch

from ..models.layers import resolve_compute_dtype

BF16_TRAINING_ERROR = (
    "training at ptv3_config compute_dtype 'bfloat16' is not ported: the "
    "backward kernels K2 dx (the mirrored conv, csrc/conv.cu), K5 / K6 "
    "(csrc/attention_dropout.cu), K7 (csrc/conv_grad.cu), K8 "
    "(csrc/gather.cu) and K10 (csrc/gather_smallc.cu) take fp32 only; "
    "train at float32 (a float32 checkpoint serves at bfloat16)")


def refuse_bf16_training(compute_dtype):
    """Raises ValueError unless compute_dtype (a ptv3_config value or a
    resolved torch dtype) computes in fp32."""
    if compute_dtype is not None and (
            isinstance(compute_dtype, torch.dtype) or
            resolve_compute_dtype(compute_dtype) is not None):
        raise ValueError(BF16_TRAINING_ERROR)


class Trainer:
    def __init__(self, model, loss_fn, optimizer, rng):
        """loss_fn(preds, batch) -> dict with 'total'; optimizer: a
        train.optim.FlatAdamW over the model's parameters; rng: the
        models.layers.Randomness every step draws from. global_step counts
        the steps taken (the JAX TrainState.step); a resume sets it. A
        model computing in bf16 raises (refuse_bf16_training)."""
        backbone = getattr(model, "ptv3_model", None)
        refuse_bf16_training(getattr(backbone, "compute_dtype", None))
        self.model, self.loss_fn = model, loss_fn
        self.optimizer, self.rng = optimizer, rng
        self.global_step = 0

    def step(self, batch):
        """One training step on a device batch; returns the detached loss
        dict (device scalars: reading them is the caller's sync)."""
        self.model.train()
        self.optimizer.zero_grad()
        self.rng.at_step(self.global_step)
        preds = self.model(batch, rng=self.rng)
        losses = self.loss_fn(preds, batch)
        losses["total"].backward()
        self.optimizer.step()
        self.global_step += 1
        return {k: v.detach() for k, v in losses.items()}


def make_val_step(model, loss_fn, decode_fn):
    """batch -> (loss dict, decoded actions): an eval-mode forward (running
    statistics, no dropout) without autograd, as the JAX make_val_step;
    both are device tensors."""

    @torch.no_grad()
    def step(batch):
        model.eval()
        preds = model(batch)
        losses = loss_fn(preds, batch)
        return {k: v.detach() for k, v in losses.items()}, decode_fn(preds)

    return step


class RunningMeter:
    """EMA meter, smooth=0.99."""

    def __init__(self, name, smooth=0.99):
        self.name, self.smooth, self.val = name, smooth, None

    def __call__(self, value):
        value = float(value)
        self.val = value if self.val is None else (
            self.val * self.smooth + value * (1 - self.smooth))
        return self.val


def batch_to_device(batch, device):
    """Host numpy batch -> tensors on `device` (bool, int and float arrays
    keep their kind)."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}
