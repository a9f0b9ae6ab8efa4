"""The train step (port of robot3dlotus_tpu/train/trainer.py
`make_train_step` and `RunningMeter`).

One step: a train-mode forward (batch-statistics norms, which update their
running statistics in place; dropout, attention dropout and order
shuffling drawn from the trainer's Randomness), the loss, the backward
(every kernel on the path has a hand-written backward) and the AdamW
update.
"""
from __future__ import annotations

import torch


class Trainer:
    def __init__(self, model, loss_fn, optimizer, rng):
        """loss_fn(preds, batch) -> dict with 'total'; optimizer: a
        train.optim.FlatAdamW over the model's parameters; rng: the
        models.layers.Randomness every step draws from."""
        self.model, self.loss_fn = model, loss_fn
        self.optimizer, self.rng = optimizer, rng

    def step(self, batch):
        """One training step on a device batch; returns the detached loss
        dict (device scalars: reading them is the caller's sync)."""
        self.model.train()
        self.optimizer.zero_grad()
        preds = self.model(batch, rng=self.rng)
        losses = self.loss_fn(preds, batch)
        losses["total"].backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in losses.items()}


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
