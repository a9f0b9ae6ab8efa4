"""The training loop (port of the step loop of
robot3dlotus_tpu/train/driver.py `run_training`): config -> dataset ->
model -> optimizer -> steps with the per-step lr, EMA meters fed every
step and a log line every TRAIN.log_steps.

One process on one device. Checkpoint save / resume, warm starts,
validation and multi-device training are not ported yet.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict

import numpy as np

from ..models.factory import build_model, resolve_device
from ..models.layers import Randomness
from .datasets.loader import KeystepBatchLoader
from .optim import build_optimizer
from .trainer import RunningMeter, Trainer, batch_to_device

LOGGER = logging.getLogger("robot3dlotus_tpu_torch.train")


@dataclasses.dataclass
class TaskSpec:
    name: str
    # (ds_cfg_dict, rng) -> dataset (indexable, returns sample lists)
    build_dataset: Callable[[dict, np.random.RandomState], Any]
    # (ds_cfg_dict, num_clouds) -> collate_fn(samples) -> host batch dict
    make_collate: Callable[[dict, int], Callable]
    # (preds, batch, act_cfg, loss_cfg) -> loss dict with 'total'
    loss_fn: Callable


def build_trainer(config, spec: TaskSpec, device="cuda"):
    """(trainer, batches, schedule): the model on `device` with seeded
    weights, the AdamW optimizer and an infinite iterator of host
    batches."""
    device = resolve_device(device)
    seed = int(config.get("SEED", 2024))
    np.random.seed(seed)
    tds_cfg = dict(config.TRAIN_DATASET)
    dataset = spec.build_dataset(tds_cfg, np.random.RandomState(seed))
    LOGGER.info("#train episodes: %d", len(dataset))
    num_clouds = int(config.TRAIN.train_batch_size)
    loader = KeystepBatchLoader(
        dataset, num_clouds=num_clouds,
        num_points=int(tds_cfg.get("num_points", 4096)),
        collate_fn=spec.make_collate(tds_cfg, num_clouds),
        shuffle_seed=seed)

    model = build_model(config.MODEL, device=device, seed=seed)
    act_cfg = dict(config.MODEL.action_config)
    # the heatmap shaping knob lives in the dataset config
    act_cfg.setdefault("pos_heatmap_type",
                       tds_cfg.get("pos_heatmap_type", "dist"))
    loss_cfg = dict(config.MODEL.loss_config)
    optimizer, schedule = build_optimizer(model, dict(config.TRAIN))
    LOGGER.info("#parameters: %.2fM",
                sum(p.numel() for p in model.parameters()) / 1e6)
    trainer = Trainer(model,
                      lambda preds, b: spec.loss_fn(preds, b, act_cfg,
                                                    loss_cfg),
                      optimizer, Randomness(seed, device))
    return trainer, iter(loader), schedule


def run_training(config, spec: TaskSpec, device="cuda"):
    """TRAIN.num_train_steps steps; returns the trainer."""
    trainer, batches, schedule = build_trainer(config, spec, device)
    device = next(trainer.model.parameters()).device
    num_clouds = int(config.TRAIN.train_batch_size)
    num_train_steps = int(config.TRAIN.num_train_steps)
    log_steps = int(config.TRAIN.get("log_steps", 1000))
    meters: Dict[str, RunningMeter] = {}
    loss_buf = []   # device scalars; read at log time, not every step
    t_start = time.time()
    for step in range(1, num_train_steps + 1):
        loss_buf.append(trainer.step(batch_to_device(next(batches), device)))
        if step % log_steps == 0 or step == num_train_steps:
            for losses in loss_buf:
                for k, v in losses.items():
                    meters.setdefault(k, RunningMeter(k))(float(v))
            loss_buf.clear()
            sps = step * num_clouds / max(time.time() - t_start, 1e-9)
            LOGGER.info("step %d: %s, lr=%.2e, samples/s=%.1f", step,
                        ", ".join(f"{k}={m.val:.4f}"
                                  for k, m in meters.items()),
                        schedule(step), sps)
    return trainer
