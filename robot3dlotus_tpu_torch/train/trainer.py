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

Across processes (JAX's make_train_step on a mesh): each process runs the
step on its shard of the batch; under a mesh (parallel/mesh.py) the
optimizer reduce-scatters the gradients over the dp group into its ZeRO-1
shard and all-gathers the update (parallel/zero.py), and a dp x tp mesh
runs the model's column / row pairs on their tp shards. The manual
ZeRO-1 step (TRAIN.zero1_manual) takes JAX's
make_manual_zero1_train_step semantics: the forward's batch norms and
loss counts are this process's own, the losses returned are their mean
over the dp group, and the running statistics are averaged over it after
the step.
"""
from __future__ import annotations

import torch

from ..models.layers import MaskedBatchNorm
from ..parallel import dist, zero


class Trainer:
    def __init__(self, model, loss_fn, optimizer, rng, net=None, mesh=None,
                 manual=False):
        """loss_fn(preds, batch[, group]) -> dict with 'total' (under a
        mesh the step passes its batch group as `group`, the group whose
        batch the losses' counts span: parallel/dist.py); optimizer: a
        train.optim.build_optimizer optimizer over the model's parameters
        (under a mesh, built with it); rng: the models.layers.Randomness
        every step draws from (under tp seeded alike on the tp processes
        of a dp index); net: the module the step runs, model in
        DistributedDataParallel under replicated data parallelism
        (parallel/dist.py wrap_model), model itself by default; mesh: the
        parallel.mesh.Mesh the step runs on; manual: the manual ZeRO-1
        step (a pure-dp mesh, the optimizer built with manual=True).
        The batch group (parallel/dist.py) is the mesh's dp group, this
        process alone (dist.LOCAL) under the manual step, and every
        process without a mesh; it is set on the model's masked batch
        norms here. global_step counts the steps taken (the JAX
        TrainState.step); a resume sets it."""
        self.model, self.loss_fn = model, loss_fn
        self.net = model if net is None else net
        self.optimizer, self.rng = optimizer, rng
        self.mesh, self.manual = mesh, bool(manual)
        if self.manual and mesh is None:
            raise ValueError("the manual ZeRO-1 step needs a mesh")
        self.dp = mesh.dp if mesh is not None else dist.world_size()
        self.batch_group = (dist.LOCAL if self.manual else
                            mesh.dp_group if mesh is not None else None)
        for m in model.modules():
            if isinstance(m, MaskedBatchNorm):
                m.group = self.batch_group
        self.global_step = 0

    def step(self, batch):
        """One training step on a device batch; returns the detached loss
        dict (device scalars: reading them is the caller's sync). With dp
        > 1 each process's losses are its share of the whole batch's
        (their sum over the dp group), and the backward takes dp times its
        total: the mean of the dp gradients (DistributedDataParallel's,
        or the ZeRO-1 reduce-scatter's) is then the gradient of the whole
        batch's loss. The manual step's backward takes its own losses, and
        it returns their mean over the dp group."""
        self.net.train()
        self.optimizer.zero_grad()
        self.rng.at_step(self.global_step)
        preds = self.net(batch, rng=self.rng)
        losses = (self.loss_fn(preds, batch) if self.mesh is None else
                  self.loss_fn(preds, batch, group=self.batch_group))
        scale = 1 if self.manual else self.dp
        (losses["total"] * scale if scale > 1 else losses["total"]).backward()
        self.optimizer.step()
        self.global_step += 1
        losses = {k: v.detach() for k, v in losses.items()}
        if self.manual:
            zero.average_stats(self.model, self.mesh)
            losses = self._dp_mean(losses)
        return losses

    def _dp_mean(self, losses):
        """The losses' mean over the dp group (JAX's pmean)."""
        if self.mesh.dp_group is dist.LOCAL:
            return losses
        keys = sorted(losses)
        vec = dist.all_reduce_sum(torch.stack([losses[k].float()
                                               for k in keys]),
                                  self.mesh.dp_group) / self.mesh.dp
        return dict(zip(keys, vec.unbind()))


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
