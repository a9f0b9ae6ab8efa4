"""The training loop (port of robot3dlotus_tpu/train/driver.py
`run_training`): config -> dataset -> model -> optimizer -> steps with the
per-step lr, EMA meters fed every step and a log line every
TRAIN.log_steps; and the run control around them:
  output_dir (config.output_dir, else experiments/<task>) with
    logs/log.txt, logs/metrics.jsonl and logs/training_config.yaml;
  auto-resume from output_dir/ckpts (TRAIN.resume_training), else a warm
    start from `checkpoint` (TRAIN.resume_encoder_only,
    checkpoint_strict_load);
  a save every TRAIN.save_steps, validation every TRAIN.val_steps
    (VAL_DATASET.use_val) with the task's best_metric tracked;
  on SIGUSR1 / SIGTERM a save at the next step boundary, a SLURM requeue
    and a return;
  a torch.profiler trace over TRAIN.profile_num_steps steps from
    TRAIN.profile_start_step (output_dir/profile);
  a final save and a final validation.

Host batches are made by the loader's TRAIN.n_workers worker processes
and copied onto the device by a PrefetchToDevice thread while the
previous step runs; validation batches are made in series (one pass, no
prefetch), as in the JAX driver. TRAIN.host_structure (default True, as
in the JAX driver) presorts each training batch by one order permutation
drawn per batch (datasets/structure.py); False lets the model redraw the
orders at every stage.

Data parallelism across processes (the JAX driver's dp mesh), one
process a card: under torchrun (`torchrun --nproc_per_node N -m
robot3dlotus_tpu_torch.train.train_simple_policy ...`) or SLURM,
run_training first joins the processes' group (parallel/dist.py; NCCL on
the card, gloo with --device cpu) and trains on cuda:LOCAL_RANK. Each
process loads its shard of every epoch's episodes
(TRAIN.train_batch_size clouds a process: the shuffle seed the same in
every process, the augmentation's and the draws' seed SEED + rank), runs
the model in DistributedDataParallel, its batch norms' statistics summed
over every process and its losses divided by the whole batch's counts,
so the averaged gradient is the whole batch's and every process takes
the same clipped step. Validation: each process TRAIN.val_num_batches
batches of its shard of the validation episodes, the sums reduced.
Logging, metrics, checkpoints and the profiler are the first process's;
the logged losses are summed over the processes (reduce_dict). Without
a launch env that asks for several processes, one process on one
device, as before.

A resumed run restarts the loader from its first batch, as the JAX driver
does (no batches are skipped); its steps' random draws are those of the
uninterrupted run (models.layers.Randomness.at_step). The final save and
validation are skipped when the last step already made them.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
import logging
import os
import time
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..configs import get_config
from ..models.factory import build_model, resolve_device
from ..models.layers import Randomness
from .checkpoint import (ModelSaver, resume_or_init, save_training_meta,
                         warm_start_variables)
from .datasets.loader import KeystepBatchLoader, PrefetchToDevice
from .datasets.structure import (HostStructureCollate, attach_sample_orders,
                                 structure_cfg_from_model)
from .logging import MetricWriter, build_logger
from ..parallel import dist
from .optim import build_optimizer
from .preempt import install_preemption_handler, requeue_self
from .trainer import RunningMeter, Trainer, batch_to_device, make_val_step

LOGGER = logging.getLogger("robot3dlotus_tpu_torch.train")


def build_args(argv=None):
    """The entry points' command line: --exp-config <yaml> [--device cpu]
    [KEY VALUE]... -> (config, device)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--exp-config", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="KEY VALUE overrides")
    args = parser.parse_args(argv)
    return get_config(args.exp_config, args.opts), args.device


@dataclasses.dataclass
class TaskSpec:
    name: str
    # (ds_cfg_dict, rng) -> dataset (indexable, returns sample lists)
    build_dataset: Callable[[dict, np.random.RandomState], Any]
    # (ds_cfg_dict, num_clouds) -> collate_fn(samples) -> host batch dict
    make_collate: Callable[[dict, int], Callable]
    # (preds, batch, act_cfg, loss_cfg) -> loss dict with 'total'
    loss_fn: Callable
    # (preds, act_cfg) -> decoded actions (device tensor)
    decode_fn: Callable
    # (decoded_actions_np, host_batch) -> {metric: (sum, count)}
    val_accuracy: Callable
    # validation metric tracked for "best"
    best_metric: str = "pos_loss"


def task_configs(config):
    """(act_cfg, loss_cfg) of the loss and the decode. The heatmap shaping
    knob lives in the dataset config."""
    act_cfg = dict(config.MODEL.action_config)
    act_cfg.setdefault("pos_heatmap_type",
                       config.TRAIN_DATASET.get("pos_heatmap_type", "dist"))
    return act_cfg, dict(config.MODEL.loss_config)


def build_loader(config, spec: TaskSpec):
    """The training loader: batches of TRAIN.train_batch_size clouds,
    loaded by TRAIN.n_workers worker processes (0: in series) and, under
    TRAIN.host_structure, presorted with their order_perm; in a process
    group this process's shard of the episodes, its draws seeded by SEED +
    rank (the shuffle by SEED, as in every process)."""
    base = int(config.get("SEED", 2024))
    seed = base + dist.rank()
    tds_cfg = dict(config.TRAIN_DATASET)
    dataset = spec.build_dataset(tds_cfg, np.random.RandomState(seed))
    LOGGER.info("#train episodes: %d", len(dataset))
    num_clouds = int(config.TRAIN.train_batch_size)
    num_workers = int(config.TRAIN.get("n_workers", 0) or 0)
    collate_fn, worker_fn = spec.make_collate(tds_cfg, num_clouds), None
    if bool(config.TRAIN.get("host_structure", True)):
        # the JAX driver's draws: one RandomState, one permutation a batch
        scfg = structure_cfg_from_model(config.MODEL)
        collate_fn = HostStructureCollate(
            collate_fn, scfg, np.random.RandomState(seed + 131071))
        if num_workers > 0:     # each cloud's sorts made in the workers
            worker_fn = functools.partial(attach_sample_orders, scfg)
    return KeystepBatchLoader(
        dataset, num_clouds=num_clouds,
        num_points=int(tds_cfg.get("num_points", 4096)),
        collate_fn=collate_fn, seed=seed, shuffle_seed=base,
        num_workers=num_workers, worker_fn=worker_fn,
        process_index=dist.rank(), process_count=dist.world_size())


def build_trainer(config, spec: TaskSpec, device="cuda"):
    """(trainer, batches, schedule): the model on `device` with seeded
    weights, the AdamW optimizer and an infinite iterator of host batches
    (build_loader). At compute_dtype bfloat16 the backbone computes in
    bf16; parameters, optimizer state and losses stay fp32. In a process
    group: cuda:LOCAL_RANK (dist.process_device), the weights from SEED
    in every process, the draws from SEED + rank, the model run in
    DistributedDataParallel (trainer.net; trainer.model the module)."""
    device = dist.process_device(resolve_device(device))
    seed = int(config.get("SEED", 2024))
    np.random.seed(seed + dist.rank())
    loader = build_loader(config, spec)
    model = build_model(config.MODEL, device=device, seed=seed)
    act_cfg, loss_cfg = task_configs(config)
    optimizer, schedule = build_optimizer(model, dict(config.TRAIN))
    LOGGER.info("#parameters: %.2fM",
                sum(p.numel() for p in model.parameters()) / 1e6)
    trainer = Trainer(model,
                      lambda preds, b: spec.loss_fn(preds, b, act_cfg,
                                                    loss_cfg),
                      optimizer, Randomness(seed + dist.rank(), device),
                      net=dist.wrap_model(model, device))
    return trainer, iter(loader), schedule


def _run_validation(val_fn, make_val_loader, spec, device):
    """Mean losses over the validation batches (named as the JAX driver
    names them: 'total' -> total_loss, 'pos' -> pos_loss) and the task's
    accuracies, sum over count. In a process group each process's losses
    are its share of the batch's (the losses divide by the whole batch's
    counts) and the processes run as many batches: the loss and accuracy
    sums are summed over them."""
    loss_sums: Dict[str, float] = {}
    acc_sums: Dict[str, list] = {}
    num_batches = 0
    for host_batch in make_val_loader():
        losses, actions = val_fn(batch_to_device(host_batch, device))
        for k, v in losses.items():
            loss_sums[k] = loss_sums.get(k, 0.0) + float(v)
        for k, (s, c) in spec.val_accuracy(
                actions.cpu().numpy(), host_batch).items():
            a = acc_sums.setdefault(k, [0.0, 0.0])
            a[0] += float(s)
            a[1] += float(c)
        num_batches += 1
    if num_batches == 0:
        return {}
    if dist.joined():
        sums = dist.reduce_dict(dict(
            {"loss/" + k: v for k, v in loss_sums.items()},
            **{f"acc/{k}/{i}": a[i] for k, a in acc_sums.items()
               for i in (0, 1)}), average=False)
        loss_sums = {k: sums["loss/" + k] for k in loss_sums}
        acc_sums = {k: [sums[f"acc/{k}/0"], sums[f"acc/{k}/1"]]
                    for k in acc_sums}
    out = {}
    for k, v in loss_sums.items():
        name = k if k.endswith("loss") else (
            "total_loss" if k == "total" else f"{k}_loss")
        out[name] = v / num_batches
    for k, (s, c) in acc_sums.items():
        out[k] = s / max(c, 1.0)
    return out


def _validation(config, spec, trainer, device):
    """A function that runs one validation and returns its metrics, or
    None without validation."""
    val_cfg = dict(config.get("VAL_DATASET", {}) or {})
    val_steps = int(config.TRAIN.get("val_steps", 0) or 0)
    if not (bool(val_cfg.pop("use_val", False)) and val_steps > 0):
        return None
    seed = int(config.get("SEED", 2024))
    val_dataset = spec.build_dataset(dict(val_cfg),
                                     np.random.RandomState(seed + 1))
    LOGGER.info("#val episodes: %d", len(val_dataset))
    val_clouds = int(config.TRAIN.get(
        "val_batch_size", config.TRAIN.train_batch_size))
    collate = spec.make_collate(dict(val_cfg), val_clouds)
    num_points = int(val_cfg.get("num_points", 4096))
    act_cfg, _ = task_configs(config)
    val_fn = make_val_step(trainer.model, trainer.loss_fn,
                           lambda preds: spec.decode_fn(preds, act_cfg))

    def make_loader():
        if not dist.joined():
            return KeystepBatchLoader(val_dataset, num_clouds=val_clouds,
                                      num_points=num_points,
                                      collate_fn=collate, one_pass=True)
        # every process the same number of batches (the losses' counts are
        # collectives): TRAIN.val_num_batches of its shard, cycling (the
        # JAX driver's); more processes than episodes share shards
        n = int(config.TRAIN.get("val_num_batches", 16) or 16)
        shards = min(dist.world_size(), max(len(val_dataset), 1))
        return itertools.islice(iter(KeystepBatchLoader(
            val_dataset, num_clouds=val_clouds, num_points=num_points,
            collate_fn=collate, seed=seed + 1,
            process_index=dist.rank() % shards, process_count=shards)), n)
    return lambda: _run_validation(val_fn, make_loader, spec, device)


def run_training(config, spec: TaskSpec, device="cuda"):
    """TRAIN.num_train_steps steps under the run control above, in the
    process group the launch env asks for (joined first, left at the
    end); returns the trainer (its model in train or eval mode, as the
    last step or validation left it)."""
    device = resolve_device(device)
    joined = dist.init_distributed(
        backend="nccl" if device.type == "cuda" else "gloo")
    try:
        return _train(config, spec, device)
    finally:
        if joined:
            dist.leave()


def _train(config, spec, device):
    output_dir = config.get("output_dir") or f"experiments/{spec.name}"
    os.makedirs(output_dir, exist_ok=True)
    first = dist.is_default_process()
    if first:
        build_logger(output_dir)
    metric_writer = MetricWriter(output_dir) if first else dist.NoOp()
    device = dist.process_device(device)
    trainer, host_batches, schedule = build_trainer(config, spec, device)
    model = trainer.model
    if dist.joined():
        LOGGER.info("data parallel: %s", dist.world_info())

    start_step = 0
    if config.TRAIN.get("resume_training", True):
        start_step = resume_or_init(trainer, output_dir)
        if start_step:
            LOGGER.info("resumed at step %d", start_step)
    warm = config.get("checkpoint", None)
    if start_step == 0 and warm:
        n_loaded, n_skipped = warm_start_variables(
            model, warm, config.MODEL,
            encoder_only=config.TRAIN.get("resume_encoder_only", False),
            strict=config.get("checkpoint_strict_load", False))
        LOGGER.info("warm start from %s: %d tensors loaded, %d skipped "
                    "(shape-filtered)", warm, n_loaded, n_skipped)
    if first:
        save_training_meta(output_dir, config)
    saver = ModelSaver(output_dir) if first else dist.NoOp()
    validate_fn = _validation(config, spec, trainer, device)
    best = {"metric": float("inf"), "step": -1}

    def validate(at_step):
        metrics = validate_fn()
        LOGGER.info("================= Validation =================")
        LOGGER.info(", ".join(f"{k}: {v:.4f}" for k, v in metrics.items()))
        metric_writer.write(at_step,
                            {f"val_{k}": v for k, v in metrics.items()})
        if metrics.get(spec.best_metric, float("inf")) < best["metric"]:
            best.update(metric=metrics[spec.best_metric], step=at_step)

    num_clouds = int(config.TRAIN.train_batch_size) * dist.world_size()
    num_train_steps = int(config.TRAIN.num_train_steps)
    log_steps = int(config.TRAIN.get("log_steps", 1000))
    save_steps = int(config.TRAIN.get("save_steps", 10000))
    val_steps = int(config.TRAIN.get("val_steps", 0) or 0)
    profile_start = int(config.TRAIN.get("profile_start_step", 0) or 0)
    profile_steps = int(config.TRAIN.get("profile_num_steps", 0) or 0)
    profiler = None
    meters: Dict[str, RunningMeter] = {}
    loss_buf = []   # device scalars; read at log time, not every step
    saved = validated = start_step if start_step else None
    samples_seen, t_start = 0, time.time()
    step = start_step
    preempted = install_preemption_handler()
    batches = PrefetchToDevice(host_batches, device)
    try:
        while step < num_train_steps:
            if preempted:
                LOGGER.info("preemption signal %s: saving at step %d and "
                            "requeueing", preempted.signum, step)
                if saved != step:
                    saver.save(model, step, trainer.optimizer)
                if first:
                    requeue_self()
                return trainer
            if profile_steps > 0 and step == profile_start and first:
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU] + (
                    [torch.profiler.ProfilerActivity.CUDA]
                    if device.type == "cuda" else []))
                profiler.start()
            loss_buf.append(trainer.step(next(batches)))
            step += 1
            samples_seen += num_clouds
            if profiler is not None and \
                    step >= profile_start + profile_steps:
                _stop_profiler(profiler, output_dir)
                profiler = None
            if step % log_steps == 0 or step == num_train_steps:
                for losses in loss_buf:
                    for k, v in dist.reduce_dict(losses,
                                                 average=False).items():
                        meters.setdefault(k, RunningMeter(k))(v)
                loss_buf.clear()
                lr = schedule(step)
                sps = samples_seen / max(time.time() - t_start, 1e-9)
                LOGGER.info("step %d: %s, lr=%.2e, samples/s=%.1f", step,
                            ", ".join(f"{k}={m.val:.4f}"
                                      for k, m in meters.items()), lr, sps)
                metric_writer.write(step, dict(
                    {k: m.val for k, m in meters.items()}, lr=lr,
                    samples_per_sec=sps))
            if step % save_steps == 0:
                saver.save(model, step, trainer.optimizer)
                saved = step
            if validate_fn and step % val_steps == 0:
                validate(step)
                validated = step
    finally:
        batches.close()
        preempted.restore()
        if profiler is not None:
            _stop_profiler(profiler, output_dir)
    if saved != step:
        saver.save(model, step, trainer.optimizer)
    if validate_fn:
        if validated != step:
            validate(step)
        LOGGER.info("Validation: best %s: %.4f at step %d", spec.best_metric,
                    best["metric"], best["step"])
    LOGGER.info("done at step %d", step)
    return trainer


def _stop_profiler(profiler, output_dir):
    profiler.stop()
    os.makedirs(os.path.join(output_dir, "profile"), exist_ok=True)
    path = os.path.join(output_dir, "profile", "trace.json")
    profiler.export_chrome_trace(path)
    LOGGER.info("profiler trace written to %s", path)
