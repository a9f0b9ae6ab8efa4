"""The train and validation steps (port of robot3dlotus_tpu/train/trainer.py
`make_train_step`, `make_val_step` and `RunningMeter`).

One step: a train-mode forward (batch-statistics norms, which update their
running statistics in place; dropout, attention dropout and order
shuffling drawn from the trainer's Randomness, reseeded from (seed, step)
as the JAX step folds in state.step), the loss, the backward (every kernel
on the path has a hand-written backward) and the optimizer's step. Under
TRAIN.gradient_accumulation_steps k the optimizer is train.optim's
MultiSteps: a step is a micro-step, which folds its gradient into the
fp32 running mean, and every k-th one updates the parameters; the step
count (the draws' seed, the driver's log and save steps) counts
micro-steps, as the JAX TrainState.step does.

At ptv3_config compute_dtype 'bfloat16' the step is the JAX package's
bf16 training step: the master parameters, the optimizer's state (and
the accumulator) and the losses stay fp32; the backbone casts the parameters to bf16 at each call
and its activations and cotangents are bf16, with every backward kernel on
the path (K2's input gradient, K5 / K6, K7, K8) taking its bf16 path; the
casts' backward widens each parameter's gradient to fp32 before the
optimizer.
"""
from __future__ import annotations

import torch

from ..parallel import dist


class Trainer:
    def __init__(self, model, loss_fn, optimizer, rng, net=None):
        """loss_fn(preds, batch) -> dict with 'total'; optimizer: a
        train.optim.build_optimizer optimizer over the model's parameters; rng: the
        models.layers.Randomness every step draws from; net: the module
        the step runs, model in DistributedDataParallel under data
        parallelism (parallel/dist.py wrap_model), model itself by
        default. global_step counts the steps taken (the JAX
        TrainState.step); a resume sets it."""
        self.model, self.loss_fn = model, loss_fn
        self.net = model if net is None else net
        self.optimizer, self.rng = optimizer, rng
        self.global_step = 0

    def step(self, batch):
        """One training step on a device batch; returns the detached loss
        dict (device scalars: reading them is the caller's sync). In a
        process group of W > 1 each process's losses are its share of the
        whole batch's (their sum), and the backward takes W times its
        total: DistributedDataParallel's mean of the W gradients is then
        the gradient of the whole batch's loss."""
        self.net.train()
        self.optimizer.zero_grad()
        self.rng.at_step(self.global_step)
        preds = self.net(batch, rng=self.rng)
        losses = self.loss_fn(preds, batch)
        world = dist.world_size()
        (losses["total"] * world if world > 1 else losses["total"]).backward()
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
