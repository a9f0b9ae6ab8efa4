#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card (an H100).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):
  1. build   the hand-written kernels K1-K8 from robot3dlotus_tpu_torch/csrc
             (one nvcc per source, all started together) and load them;
  2. capture one `Actioner.predict` at the release width (4096 points) and
             one `predict_batch` of 4 with recorders on the kernel call
             sites, keeping every kernel input the main path produces;
  3. kernels hold each captured call against the kernel's plain PyTorch
             version on the card (|kernel - plain| <= 1e-4 * max(1,
             max|plain|): fp32 on both sides, other summation orders), and
             time the B=1 calls: kernel, plain version and, where one
             PyTorch call computes the same function, that call (CUDA
             events: median of 21 rounds of 10 back-to-back calls, after 3
             warm-up calls);
  4. serving launch counters to 0, then 4 `predict` requests and one
             `predict_batch` of the same 4 observations (4 cameras of
             256 x 256 xyz/rgb, seeded tabletop scenes), counters read: each
             kernel must have launched its per-forward count 5 times; batch
             and sequential actions must agree; p50 request latency printed;
  5. breakdown host preprocessing vs device forward per request, and a
             torch.profiler window over 3 forwards: device time by kernel
             and the device's idle share (chiprun_out/profile_forward.txt);
  6. reference the card's logits for one observation against the same
             weights on the CPU (the plain path);
  7. train-capture  the trainer of the release YAML on synthetic_reach
             (train_simple_policy's build_trainer, B = 32 clouds x 4096
             points, release dropout rates, order shuffling), one step with
             recorders that keep every kernel input and the cotangent of
             every kernel output;
  8. training launch counters to 0, 5 training steps, counters read: each
             kernel of the training path must have launched its per-step
             count 5 times; each step's losses finite; step time p50 (host
             clock after synchronize), clouds/s, peak memory; then a
             torch.profiler window over 2 steps: device time by kernel
             group (DEVICE_GROUPS) and the device's idle share
             (chiprun_out/profile_train.txt);
  9. train-kernels hold the captured training calls against the plain
             versions: K5 and K6 with the kernel's own dumped keep mask (the
             mask also bit-equal to the PyTorch Philox generator, its keep
             fraction within 5 binomial sigmas of 1 - rate), K5 at rate 0
             against K1, K7 at the CPE and the stem shapes, K8, and the
             conv's dx (K8 onto voxel owners, then K2 with the mirrored
             weight) against the exact adjoint (autograd of
             subm_conv_plain) on every row; |kernel - plain| <= 1e-4 *
             max|plain| (gradients are far below 1); time K5-K8 per
             training step (CUDA events, median of 5 rounds of 2 calls
             after a warm-up call);
 10. step-check one step at dropout 0 with injected order permutations, B =
             2 of the same batch, the same weights, on the card and on the
             CPU (plain versions): losses, every gradient, every updated
             parameter and running statistic;
 11. entry     train_simple_policy.main on the card for ENTRY_STEPS steps
             (launch counters to 0 before, read after against the per-step
             counts; logged losses finite); the end-to-end training rate,
             host batches included, over the second half.
It prints the kernels line, the card's name and power limit, and as its
last line {"ok": true, "device": {...}}. It needs one CUDA card and exits
non-zero without one.
"""
from __future__ import annotations

import json
import logging
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from robot3dlotus_tpu_torch.configs import get_config
from robot3dlotus_tpu_torch.eval.actioner import Actioner
from robot3dlotus_tpu_torch.eval.synthetic_obs import synthetic_observation
from robot3dlotus_tpu_torch.models import layers, ptv3
from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.models.layers import Randomness
from robot3dlotus_tpu_torch.ops import (attention, conv, cuda_lib, gather,
                                        patching, pooling, sparse_conv, stem)
from robot3dlotus_tpu_torch.train.driver import build_trainer
from robot3dlotus_tpu_torch.train.optim import build_optimizer
from robot3dlotus_tpu_torch.train import train_simple_policy
from robot3dlotus_tpu_torch.train.train_simple_policy import SPEC
from robot3dlotus_tpu_torch.train.trainer import Trainer, batch_to_device

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "robot3dlotus_tpu_torch", "configs", "rlbench",
                      "simple_policy_ptv3.yaml")
CLI_OPTS = ["TRAIN_DATASET.instr_embed_file", "None"]
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12    # H100 SXM data sheet, fp32 outside tensor cores
TOL = 1e-4
# launches per forward of the release model (5 enc + 4 dec Blocks; one
# stem; four decoder unpools; inputs presorted, so no entry-sort gather)
PER_FORWARD = {"patch_attention": 9, "subm_conv": 9, "stem_conv": 1,
               "gather_rows": 4}
KERNELS = {
    "patch_attention": ("robot3dlotus_tpu_torch/csrc/attention.cu",
                        "robot3dlotus_tpu/ops/pallas_attention.py:66"),
    "subm_conv": ("robot3dlotus_tpu_torch/csrc/conv.cu",
                  "robot3dlotus_tpu/ops/pallas_conv.py:397"),
    "stem_conv": ("robot3dlotus_tpu_torch/csrc/stem.cu",
                  "robot3dlotus_tpu/ops/pallas_stem.py:138"),
    "gather_rows": ("robot3dlotus_tpu_torch/csrc/gather.cu",
                    "robot3dlotus_tpu/ops/pallas_gather.py:133"),
    "patch_attention_dropout": (
        "robot3dlotus_tpu_torch/csrc/attention_dropout.cu",
        "robot3dlotus_tpu/ops/pallas_attention.py:232"),
    "patch_attention_dropout_bwd": (
        "robot3dlotus_tpu_torch/csrc/attention_dropout.cu",
        "robot3dlotus_tpu/ops/pallas_attention.py:247"),
    "conv_weight_grad": ("robot3dlotus_tpu_torch/csrc/conv_grad.cu",
                         "robot3dlotus_tpu/ops/pallas_conv.py:569"),
    "scatter_rows_add": ("robot3dlotus_tpu_torch/csrc/gather.cu",
                         "robot3dlotus_tpu/ops/pallas_gather.py:160"),
}
# the trainer of the release YAML on the learnable synthetic store
# (scripts/e2e_learning_proof.py makes the same overrides)
TRAIN_OPTS = ["TRAIN_DATASET.data_dir", "synthetic_reach",
              "TRAIN_DATASET.instr_embed_file", "None",
              "TRAIN_DATASET.taskvar_instr_file", "None",
              "TRAIN_DATASET.taskvar_file", "None",
              "TRAIN_DATASET.augment_pc", "True"]
TRAIN_STEPS = 5
PROFILE_STEPS = 2
ENTRY_STEPS = 6   # train_simple_policy.main; the rate is read over the last 3
# launches per training step of the release model: K2 9 forward + 9 dx;
# K4 the stage-0 entry sort, 4 shuffled child entry sorts, 4 unpools; K7
# 9 CPE + the stem; K8 the backward of every K4 call whose input needs a
# gradient (not the stage-0 sort of the data) and the owner sum of each
# of the 9 conv dx
PER_STEP = {"subm_conv": 18, "stem_conv": 1, "gather_rows": 9,
            "patch_attention_dropout": 9, "patch_attention_dropout_bwd": 9,
            "conv_weight_grad": 10, "scatter_rows_add": 17,
            "patch_attention": 0, "attention_dropout_mask": 0}
TRAIN_KERNELS = ("patch_attention_dropout", "patch_attention_dropout_bwd",
                 "conv_weight_grad", "scatter_rows_add")
# the step check's order permutations: stage 0 and the four poolings
CHECK_PERMS = [[2, 0, 3, 1], [1, 3, 0, 2], [3, 2, 1, 0], [0, 2, 1, 3],
               [2, 3, 0, 1]]
GRAD_TOL = 1e-3   # card vs CPU gradients of the whole step, per tensor
# device kernels of a training step by name, first match wins
DEVICE_GROUPS = [
    ("K7 conv_weight_grad", ("conv_weight_grad_kernel", "sum_splits")),
    ("K2 subm_conv", ("subm_conv_kernel",)),
    ("K6 attention dropout bwd", ("attn_drop_bwd",)),
    ("K5 attention dropout fwd", ("attn_drop_fwd",)),
    ("K3 stem_conv", ("stem_conv",)),
    ("K4/K8 gather, scatter-add", ("gather_rows_kernel",
                                   "scatter_rows_add_kernel")),
    ("fp32 GEMM (cuBLAS/CUTLASS)", ("gemm", "sgemm")),
    ("LayerNorm fwd/bwd", ("layer_norm",)),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "Memset", "Memcpy")),
    ("PyTorch scatter/gather/sort", ("scatter", "gather", "sort", "Sort",
                                     "index")),
]


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, rounds=21, reps=10, warmup=3):
    """Median over `rounds` of the mean time of `reps` back-to-back calls
    between two CUDA events. A call shorter than its host-side launch cost
    measures that cost: it is what the caller pays. The training shapes
    take rounds=5, reps=2, warmup=1 (TRAIN_TIMING)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


# ------------------------------------------------------------- capture -----

class Recorder:
    """Wraps a kernel wrapper where the model calls it and keeps clones of
    the inputs of each call and, when the output takes part in a backward,
    of its cotangent (None otherwise)."""

    def __init__(self, fn):
        self.fn, self.calls, self.grads = fn, [], []

    def __call__(self, *args):
        self.calls.append(tuple(a.detach().clone() if torch.is_tensor(a)
                                else a for a in args))
        self.grads.append(None)
        out = self.fn(*args)
        if out.requires_grad:
            i = len(self.grads) - 1
            out.register_hook(lambda g: self.grads.__setitem__(
                i, g.detach().clone(memory_format=torch.contiguous_format)))
        return out


SERVING_SITES = [(layers, "patch_attention", "patch_attention"),
                 (sparse_conv, "subm_conv", "subm_conv"),
                 (sparse_conv, "stem_conv", "stem_conv"),
                 (pooling, "gather_rows", "gather_rows"),
                 (ptv3, "gather_rows", "gather_rows")]
TRAIN_SITES = [(layers, "patch_attention_dropout", "attention"),
               (sparse_conv, "subm_conv", "subm_conv"),
               (sparse_conv, "stem_conv", "stem_conv"),
               (pooling, "gather_rows", "gather_rows"),
               (ptv3, "gather_rows", "gather_rows"),
               (patching, "gather_rows", "gather_rows")]


def capture(run, sites):
    """Calls `run` with recorders on the kernel call sites; returns, by
    kernel, the (inputs, output cotangent) of every call."""
    recs = {}
    saved = []
    for mod, attr, kernel in sites:
        rec = Recorder(getattr(mod, attr))
        saved.append((mod, attr, rec.fn))
        setattr(mod, attr, rec)
        recs.setdefault(kernel, []).append(rec)
    try:
        run()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return {k: [c for r in v for c in zip(r.calls, r.grads)]
            for k, v in recs.items()}


def capture_main_path(run):
    """The serving forward's recorded kernel inputs by kernel."""
    return {k: [args for args, _ in v]
            for k, v in capture(run, SERVING_SITES).items()}


# ------------------------------------------------------------- kernels -----

def _bound(nbytes, flops):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, t_b, t_f


def _sdpa(q, k, v, kv, scale):
    mask = kv[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale)


def check_call(kernel, args, timed=True):
    """One captured call: error vs plain and, if `timed`, times and
    bound."""
    if kernel == "patch_attention":
        q, k, v, kv, scale = args
        run = lambda: attention.patch_attention(q, k, v, kv, scale)  # noqa
        plain = lambda: attention.patch_attention_plain(q, k, v, kv, scale)  # noqa
        library = lambda: _sdpa(q, k, v, kv, scale)  # noqa: E731
        G, H, P, Dh = q.shape
        shape = [G, H, P, Dh]
        nbytes = 4 * 4 * q.numel() + kv.numel()
        flops = 4 * G * H * P * P * Dh
    elif kernel in ("subm_conv", "stem_conv"):
        x, idx, ok, w = args[:4]
        if kernel == "subm_conv":
            bias = args[4]
            run = lambda: conv.subm_conv(x, idx, ok, w, bias)  # noqa
            plain = lambda: conv.subm_conv_plain(x, idx, ok, w, bias)  # noqa
        else:
            run = lambda: stem.stem_conv(x, idx, ok, w)  # noqa: E731
            plain = lambda: stem.stem_conv_plain(x, idx, ok, w)  # noqa
        library = None
        B, N, Cin = x.shape
        K, _, Cout = w.shape
        shape = [B, N, K, Cin, Cout]
        nbytes = 4 * (x.numel() + w.numel() + B * N * Cout + Cout) + \
            5 * idx.numel()
        flops = 2 * Cin * Cout * int(ok.sum())      # this cloud's live links
    else:
        x, idx = args
        run = lambda: gather.gather_rows(x, idx)  # noqa: E731
        plain = lambda: gather.gather_rows_plain(x, idx)  # noqa: E731
        idx_l = idx.long()[..., None].expand(-1, -1, x.shape[-1])
        library = lambda: torch.gather(x, 1, idx_l)  # noqa: E731
        shape = list(x.shape) + [idx.shape[1]]
        nbytes = 4 * (x.numel() + idx.numel() + idx.numel() * x.shape[-1])
        flops = 0
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale_ref = max(1.0, float(want.abs().max()))
    if not bool(torch.isfinite(got).all()) or err > TOL * scale_ref:
        raise AssertionError(f"{kernel} {shape}: max |kernel - plain| = "
                             f"{err} > {TOL} * {scale_ref}")
    out = {"shape": shape, "max_abs_err": err, "max_rel_err": err / scale_ref}
    if not timed:
        return out
    bound_ms, t_b, t_f = _bound(nbytes, flops)
    return {**out, "ms": cuda_ms(run),
            "plain_ms": cuda_ms(plain),
            "library_ms": cuda_ms(library) if library else None,
            "bound_ms": bound_ms, "bytes_s": t_b, "flops_s": t_f}


def kernel_phase(captured, captured_batch):
    """Every captured call of the B=1 forward is checked and timed; every
    call of the batch-of-4 forward is checked."""
    rows, detail = {}, []
    for kernel in PER_FORWARD:
        for cap in (captured, captured_batch):
            if len(cap[kernel]) != PER_FORWARD[kernel]:
                raise AssertionError(
                    f"{kernel}: captured {len(cap[kernel])} calls, "
                    f"expected {PER_FORWARD[kernel]}")
        res = [check_call(kernel, c) for c in captured[kernel]]
        res_b = [check_call(kernel, c, timed=False)
                 for c in captured_batch[kernel]]
        detail += [dict(r, name=kernel) for r in res + res_b]
        lib = [r["library_ms"] for r in res]
        rows[kernel] = {
            "max_abs_err": max(r["max_abs_err"] for r in res + res_b),
            "max_rel_err": max(r["max_rel_err"] for r in res + res_b),
            "ms": sum(r["ms"] for r in res),
            "plain_ms": sum(r["plain_ms"] for r in res),
            "bound_ms": sum(r["bound_ms"] for r in res),
            "bound_by": "bytes" if sum(r["bytes_s"] for r in res) >=
            sum(r["flops_s"] for r in res) else "operations",
            "library_ms": None if None in lib else sum(lib),
        }
        log(f"[kernels] {kernel}: {len(res)} calls per forward, "
            f"max_abs_err {rows[kernel]['max_abs_err']:.3g}, "
            f"{rows[kernel]['ms']:.4f} ms (plain "
            f"{rows[kernel]['plain_ms']:.4f}, bound "
            f"{rows[kernel]['bound_ms']:.4f})")
    return rows, detail


# ------------------------------------------------------------- serving -----

def requests(observations):
    return [{"task_str": "close_jar", "variation": i, "step_id": 0,
             "obs_state_dict": o} for i, o in enumerate(observations)]


def serving_phase(actioner, observations):
    payloads = requests(observations)
    actioner.rng = np.random.default_rng(7)
    actioner.predict(**payloads[0])                      # warm-up
    torch.cuda.synchronize()

    cuda_lib.reset_launches()
    actioner.rng = np.random.default_rng(1)
    seq, lat = [], []
    for p in payloads:
        t0 = time.perf_counter()
        seq.append(actioner.predict(**p)["action"])
        lat.append(time.perf_counter() - t0)
    actioner.rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    bat = [o["action"] for o in actioner.predict_batch(payloads)]
    batch_s = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)

    forwards = len(payloads) + 1
    for k, per in PER_FORWARD.items():
        if launches[k] != per * forwards:
            raise AssertionError(f"{k}: {launches[k]} launches in the main "
                                 f"path, expected {per} x {forwards}")
    for i, (s, b) in enumerate(zip(seq, bat)):
        if s.shape != (8,) or not np.isfinite(s).all():
            raise AssertionError(f"request {i}: bad action {s}")
        if not np.allclose(s, b, atol=1e-5, rtol=0):
            raise AssertionError(f"request {i}: predict_batch {b} != "
                                 f"predict {s}")
    actioner.rng = np.random.default_rng(1)
    points = [len(actioner._host_prep("close_jar", i, o, None)[1])
              for i, o in enumerate(observations)]
    log(f"[serving] points per request {points}; predict p50 "
        f"{np.median(lat) * 1e3:.2f} ms (all {[round(t * 1e3, 2) for t in lat]}"
        f"); predict_batch of {len(payloads)} {batch_s * 1e3:.2f} ms; "
        f"launches {launches}")
    return {"predict_p50_ms": float(np.median(lat)) * 1e3,
            "predict_ms": [t * 1e3 for t in lat],
            "predict_batch4_ms": batch_s * 1e3, "points": points,
            "launches": launches, "actions": [a.tolist() for a in seq]}


def breakdown_phase(actioner, observations, out_dir):
    """Where a request's time goes: host preprocessing vs the device
    forward (batch upload, model, decode, readback), host clock; then a
    torch.profiler window over 3 forwards for device time by kernel and the
    device's busy share of the window."""
    prep_ms, fwd_ms = [], []
    rows = []
    for i, o in enumerate(observations):
        t0 = time.perf_counter()
        emb, pc_ft, _, _ = actioner._host_prep("close_jar", i, o, None)
        t1 = time.perf_counter()
        actioner._forward([(pc_ft, emb)], 1)
        t2 = time.perf_counter()
        prep_ms.append((t1 - t0) * 1e3)
        fwd_ms.append((t2 - t1) * 1e3)
        rows.append((pc_ft, emb))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in rows[:3]:
            actioner._forward([r], 1)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)
    # device-side events only (kernels, memcpy/memset): the CPU-side aten
    # ops that launched them report the same time again
    kernels = sorted(((e.key, dev_us(e) / 1e3 / 3, e.count // 3)
                      for e in events
                      if str(e.device_type).endswith("CUDA") and dev_us(e)),
                     key=lambda t: -t[1])
    busy_ms = sum(k[1] for k in kernels)
    with open(os.path.join(out_dir, "profile_forward.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    fwd_p50 = float(np.median(fwd_ms))
    out = {"host_prep_ms_p50": float(np.median(prep_ms)),
           "forward_ms_p50": fwd_p50,
           "profiled_forward_wall_ms": wall_ms / 3,
           "device_busy_ms_per_forward": busy_ms,
           "device_idle_share": 1.0 - busy_ms / fwd_p50,
           "top_device_ops": [{"name": k[0][:80], "ms": k[1], "count": k[2]}
                              for k in kernels[:15]]}
    log(f"[breakdown] host prep p50 {out['host_prep_ms_p50']:.2f} ms, "
        f"device forward p50 {fwd_p50:.2f} ms (profiled: "
        f"{out['profiled_forward_wall_ms']:.2f} ms wall); device busy "
        f"{busy_ms:.2f} ms per forward, idle share of the unprofiled "
        f"forward {out['device_idle_share']:.3f}")
    for k in out["top_device_ops"][:8]:
        log(f"[breakdown]   {k['ms']:.4f} ms x{k['count']}  {k['name']}")
    return out


def reference_phase(actioner, obs):
    """The card's logits against the same weights run on the CPU."""
    actioner.rng = np.random.default_rng(3)
    emb, pc_ft, _, _ = actioner._host_prep("close_jar", 0, obs, None)
    batch = actioner._batch([(pc_ft, emb)], 1)
    cpu_model = Actioner(CONFIG, cli_opts=CLI_OPTS, device="cpu").model
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               actioner.model.state_dict().items()})
    with torch.inference_mode():
        gpu = actioner.model(batch)
        cpu = cpu_model({k: v.cpu() for k, v in batch.items()})
    errs = {}
    for k in ("pos", "rot", "open"):
        ref = cpu[k]
        errs[k] = float((gpu[k].cpu() - ref).abs().max())
        lim = 1e-3 * max(1.0, float(ref.abs().max()))
        if k == "pos":   # masked candidates hold -1e9 on both sides
            lim = 1e-3 * max(1.0, float(ref[ref > -1e8].abs().max()))
        if errs[k] > lim:
            raise AssertionError(f"{k}: card vs CPU max |diff| {errs[k]} > "
                                 f"{lim}")
    errs["pool_overflow"] = int(gpu["pool_overflow"])
    log(f"[reference] card vs CPU logits, max |diff|: {errs}")
    return errs


# ------------------------------------------------------------ training -----

TRAIN_TIMING = dict(rounds=5, reps=2, warmup=1)


def train_config(*opts):
    return get_config(CONFIG, TRAIN_OPTS + list(opts))


def host_batches(batches, n):
    """n host batches from the trainer's loader, and the host ms each took
    (keystep preprocessing + collate)."""
    out, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        out.append(next(batches))
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def _losses(losses):
    out = {k: float(v) for k, v in losses.items()}
    if not all(math.isfinite(v) for v in out.values()):
        raise AssertionError(f"non-finite losses {out}")
    return out


def _device_ops(events, n):
    """(name, device ms per unit, count per unit) of the device-side
    events of a profile over n units, largest first."""
    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)
    return sorted(((e.key, dev_us(e) / 1e3 / n, e.count // n) for e in events
                   if str(e.device_type).endswith("CUDA") and dev_us(e)),
                  key=lambda t: -t[1])


def training_phase(trainer, batches, out_dir):
    """5 counted steps, then a profiler window over 2 more."""
    dev = [batch_to_device(b, "cuda") for b in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    step_ms, losses = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out = trainer.step(dev[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(_losses(out))
        log(f"[training] step {i + 1}: {losses[-1]}")
    launches = dict(cuda_lib.LAUNCHES)
    for k, per in PER_STEP.items():
        if launches[k] != per * TRAIN_STEPS:
            raise AssertionError(f"{k}: {launches[k]} launches in "
                                 f"{TRAIN_STEPS} training steps, expected "
                                 f"{per} per step")
    peak = torch.cuda.max_memory_allocated()

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILE_STEPS):
            trainer.step(dev[TRAIN_STEPS + i])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    ops = _device_ops(events, PROFILE_STEPS)
    with open(os.path.join(out_dir, "profile_train.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=80))
    busy = sum(o[1] for o in ops)
    groups = {}
    for name, ms, count in ops:
        g = next((label for label, keys in DEVICE_GROUPS
                  if any(k in name for k in keys)), "other")
        acc = groups.setdefault(g, [0.0, 0])
        acc[0] += ms
        acc[1] += count
    p50 = float(np.median(step_ms))
    out = {"step_ms": step_ms, "step_ms_p50": p50,
           "clouds_per_s": trainer_batch(batches) * 1e3 / p50,
           "peak_mem_gib": peak / 2 ** 30, "losses": losses,
           "launches_per_step": {k: launches[k] / TRAIN_STEPS
                                 for k in launches},
           "profiled_step_wall_ms": wall_ms / PROFILE_STEPS,
           "device_busy_ms_per_step": busy,
           "device_idle_share": 1.0 - busy / p50,
           "device_ms_by_group": {g: {"ms": v[0], "count": v[1]}
                                  for g, v in sorted(
                                      groups.items(), key=lambda t: -t[1][0])},
           "top_device_ops": [{"name": o[0][:80], "ms": o[1], "count": o[2]}
                              for o in ops[:20]]}
    log(f"[training] B={trainer_batch(batches)} x "
        f"{batches[0]['pc_fts'].shape[1]} points: step p50 {p50:.1f} ms "
        f"(all {[round(t, 1) for t in step_ms]}), "
        f"{out['clouds_per_s']:.1f} clouds/s, peak memory "
        f"{out['peak_mem_gib']:.2f} GiB")
    log(f"[training] launches per step {out['launches_per_step']}")
    log(f"[training] device busy {busy:.1f} ms per step (profiled wall "
        f"{out['profiled_step_wall_ms']:.1f} ms), idle share of the "
        f"unprofiled step {out['device_idle_share']:.3f}")
    for g, v in out["device_ms_by_group"].items():
        log(f"[training]   {v['ms']:.3f} ms x{v['count']}  {g}")
    return out, launches


def trainer_batch(batches):
    return int(batches[0]["pc_fts"].shape[0])


def _err(got, want, what, tol=TOL):
    """max |got - want| after a sync; raises past tol * max|want|. The
    training kernels carry gradients, whose scale is far below 1 (~1e-7 at
    the release loss), so the bar is relative to the reference's own
    largest value, not to max(1, |want|)."""
    torch.cuda.synchronize()
    got, want = got.detach(), want.detach()
    if not got.numel():
        return 0.0
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not bool(torch.isfinite(got).all()) or err > tol * scale or \
            (scale == 0.0 and err > 0.0):
        raise AssertionError(f"{what}: max |kernel - plain| = {err} > "
                             f"{tol} * {scale}")
    return err


def _timed(run, plain, library, nbytes, flops):
    bound_ms, t_b, t_f = _bound(nbytes, flops)
    return {"ms": cuda_ms(run, **TRAIN_TIMING),
            "plain_ms": cuda_ms(plain, **TRAIN_TIMING),
            "library_ms": cuda_ms(library, **TRAIN_TIMING)
            if library else None,
            "bound_ms": bound_ms, "bytes_s": t_b, "flops_s": t_f}


def check_attention_train(call):
    """K5 and K6 on one captured call: the kernel's dumped mask, K5 at rate
    0 against K1, keep fraction, kernel vs plain, times."""
    (q, k, v, kv, scale, rate, seed), g = call
    G, H, P, Dh = q.shape
    keep = attention.attention_dropout_mask(seed, G, H, P, rate, q.device)
    n = keep.numel()
    frac = float(keep.float().mean())
    if abs(frac - (1 - rate)) > 5 * math.sqrt(rate * (1 - rate) / n):
        raise AssertionError(f"keep fraction {frac} at rate {rate}")
    e0 = _err(attention.patch_attention_dropout(q, k, v, kv, scale, 0.0, 0),
              attention.patch_attention(q, k, v, kv, scale), "K5 rate 0")
    run5 = lambda: attention.patch_attention_dropout(  # noqa: E731
        q, k, v, kv, scale, rate, seed)
    plain5 = lambda: attention.patch_attention_dropout_plain(  # noqa: E731
        q, k, v, kv, scale, rate, keep)
    e5 = _err(run5(), plain5(), f"K5 {[G, H, P, Dh]}")
    run6 = lambda: attention.patch_attention_dropout_bwd(  # noqa: E731
        q, k, v, kv, g, scale, rate, seed)
    plain6 = lambda: attention.patch_attention_dropout_bwd_plain(  # noqa
        q, k, v, kv, scale, rate, keep, g)
    e6 = max(_err(a, b, f"K6 d{nm} {[G, H, P, Dh]}")
             for a, b, nm in zip(run6(), plain6(), "qkv"))
    mask = kv[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, dropout_p=rate, scale=scale)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                         dropout_p=rate, scale=scale)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        out, (qg, kg, vg), g, retain_graph=True)
    qb = 4 * q.numel()
    r5 = dict(_timed(run5, plain5, sdpa, 4 * qb + kv.numel(),
                     4 * G * H * P * P * Dh), max_abs_err=e5,
              rate0_vs_k1_err=e0, keep_fraction=frac, shape=[G, H, P, Dh])
    r6 = dict(_timed(run6, plain6, sdpa_bwd, 7 * qb + kv.numel(),
                     10 * G * H * P * P * Dh), max_abs_err=e6,
              shape=[G, H, P, Dh])
    return r5, r6


def check_weight_grad(call):
    """K7 on one captured conv or stem call (its x, map and the cotangent
    of its output)."""
    (x, idx, ok, w, *_), g = call
    K, cin, cout = w.shape
    run = lambda: conv.conv_weight_grad(x, idx, ok, g)  # noqa: E731
    plain = lambda: conv.conv_weight_grad_plain(x, idx, ok, g)  # noqa
    err = _err(run(), plain(), f"K7 {[K, cin, cout]}")
    nbytes = 4 * (x.numel() + g.numel() + w.numel()) + 5 * idx.numel()
    return dict(_timed(run, plain, None, nbytes,
                       2 * cin * cout * int(ok.sum())),
                max_abs_err=err, shape=list(x.shape[:2]) + [K, cin, cout])


def check_conv_dx(call):
    """The conv backward's dx (K8 onto voxel owners, then K2 with the
    mirrored weight) against the exact adjoint (autograd of
    subm_conv_plain) on every row, and the mirrored K2 against its plain
    version. Returns the row and the K8 result of the owner scatter."""
    (x, idx, ok, w, bias), g = call
    wm = conv.mirror_weight(w)
    e_k2 = _err(conv.subm_conv(g, idx, ok, wm),
                conv.subm_conv_plain(g, idx, ok, wm), "mirrored K2")
    xr = x.clone().requires_grad_()
    exact = torch.autograd.grad(conv.subm_conv_plain(xr, idx, ok, w), xr,
                                g)[0]
    e_dx = _err(conv.conv_input_grad(g, idx, ok, w), exact,
                "conv dx vs the exact adjoint")
    centre = idx.shape[-1] // 2
    owner = idx[..., centre]
    gv = torch.where(ok[..., centre, None], g, torch.zeros_like(g))
    k8 = check_scatter_add(((gv, owner), gv))
    return {"shape": list(x.shape) + [w.shape[-1]], "max_abs_err": e_dx,
            "mirrored_k2_err": e_k2}, k8


def check_scatter_add(call):
    """K8 on one captured K4 call (its input and the cotangent of its
    output), or on a conv's owner scatter (x stands in for the output
    shape)."""
    (x, idx), g = call
    B, n, D = x.shape
    run = lambda: gather.scatter_rows_add(g, idx, n)  # noqa: E731
    plain = lambda: gather.scatter_rows_add_plain(g, idx, n)  # noqa: E731
    flat = (idx.long() + torch.arange(B, device=idx.device)[:, None] * n
            ).reshape(-1)
    library = lambda: torch.zeros(  # noqa: E731
        B * n, D, device=g.device).index_add_(0, flat, g.reshape(-1, D))
    err = _err(run(), plain(), f"K8 {list(g.shape)} -> {n}")
    nbytes = 4 * (g.numel() + idx.numel() + B * n * D)
    return dict(_timed(run, plain, library, nbytes, g.numel()),
                max_abs_err=err, shape=list(g.shape) + [n])


def train_kernel_phase(captured):
    """Every K5-K8 input of one captured training step: checked and timed;
    returns the kernels-line rows (sums over the step) and the detail."""
    att = [c for c in captured["attention"]]
    convs = [c for c in captured["subm_conv"] if c[1] is not None]
    stems = [c for c in captured["stem_conv"] if c[1] is not None]
    scat = [c for c in captured["gather_rows"] if c[1] is not None]
    expect = {"attention": 9, "conv": 9, "stem": 1, "scatter": 8}
    # K8 per step: these 8 K4 backwards and the 9 conv dx owner sums
    for name, got in (("attention", att), ("conv", convs), ("stem", stems),
                      ("scatter", scat)):
        if len(got) != expect[name]:
            raise AssertionError(f"captured {len(got)} {name} calls with a "
                                 f"cotangent, expected {expect[name]}")
    q, k, v, kv, scale, rate, seed = att[0][0]
    G, H, P, _ = q.shape
    keep = attention.attention_dropout_mask(seed, G, H, P, rate, q.device)
    if not torch.equal(keep, attention.philox_keep_mask(seed, G, H, P, rate,
                                                        q.device)):
        raise AssertionError("K5's mask differs from philox_keep_mask")
    del keep
    res = {name: [] for name in TRAIN_KERNELS}
    for c in att:
        r5, r6 = check_attention_train(c)
        res["patch_attention_dropout"].append(r5)
        res["patch_attention_dropout_bwd"].append(r6)
    res["conv_weight_grad"] = [check_weight_grad(c) for c in convs + stems]
    res["scatter_rows_add"] = [check_scatter_add(c) for c in scat]
    conv_dx = []
    for c in convs:
        row, k8 = check_conv_dx(c)
        conv_dx.append(row)
        res["scatter_rows_add"].append(k8)
    rows = {}
    for name, rs in res.items():
        lib = [r["library_ms"] for r in rs]
        rows[name] = {
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "bytes" if sum(r["bytes_s"] for r in rs) >=
            sum(r["flops_s"] for r in rs) else "operations",
            "library_ms": None if None in lib else sum(lib)}
        log(f"[train-kernels] {name}: {len(rs)} calls per step, max_abs_err "
            f"{rows[name]['max_abs_err']:.3g}, {rows[name]['ms']:.3f} ms "
            f"(plain {rows[name]['plain_ms']:.3f}, bound "
            f"{rows[name]['bound_ms']:.3f}, library "
            f"{rows[name]['library_ms']})")
    k5 = res["patch_attention_dropout"]
    log(f"[train-kernels] K5 keep fractions "
        f"{[round(r['keep_fraction'], 5) for r in k5]}; K5 at rate 0 vs K1 "
        f"max err {max(r['rate0_vs_k1_err'] for r in k5):.3g}")
    log(f"[train-kernels] conv dx (K8 + mirrored K2) vs the exact adjoint: "
        f"max err {max(m['max_abs_err'] for m in conv_dx):.3g}; mirrored K2 "
        f"vs plain {max(m['mirrored_k2_err'] for m in conv_dx):.3g}")
    return rows, {"calls": res, "conv_dx": conv_dx}


def step_check_phase(host_batch):
    """One step at dropout 0 with injected order permutations on B = 2 of
    the batch, the same seeded weights on the card and on the CPU."""
    cfg = train_config("MODEL.ptv3_config.attn_drop", "0.0",
                       "MODEL.ptv3_config.proj_drop", "0.0",
                       "MODEL.action_config.dropout", "0.0")
    batch = {k: v[:2] for k, v in host_batch.items()}
    act_cfg = dict(cfg.MODEL.action_config, pos_heatmap_type=cfg.TRAIN_DATASET
                   .get("pos_heatmap_type", "dist"))
    loss_cfg = dict(cfg.MODEL.loss_config)
    from robot3dlotus_tpu_torch.models.simple_policy import compute_loss
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg.MODEL, device=dev, seed=1)
        opt, _ = build_optimizer(model, dict(cfg.TRAIN))
        trainer = Trainer(model, lambda p, b: compute_loss(
            p, b, act_cfg, loss_cfg), opt, Randomness(0, dev,
                                                      perms=CHECK_PERMS))
        t0 = time.perf_counter()
        losses = trainer.step(batch_to_device(batch, dev))
        losses = _losses(losses)
        grads = {n: p.grad.detach().cpu() for n, p in
                 model.named_parameters()}
        state = {n: t.detach().cpu() for n, t in model.state_dict().items()}
        out[dev] = (losses, grads, state, time.perf_counter() - t0)
        del model, trainer, opt
    (lc, gc, sc, tc), (lr, gr, sr, tr) = out["cuda"], out["cpu"]
    errs = {"loss": max(abs(lc[k] - lr[k]) / max(1.0, abs(lr[k]))
                        for k in lr)}
    if errs["loss"] > TOL:
        raise AssertionError(f"card vs CPU losses {lc} vs {lr}")
    gmax = max(float(g.abs().max()) for g in gr.values())
    worst = 0.0
    for n, g in gr.items():
        scale = max(float(g.abs().max()), 1e-3 * gmax)
        rel = float((gc[n] - g).abs().max()) / scale
        worst = max(worst, rel)
        if rel > GRAD_TOL:
            raise AssertionError(f"card vs CPU gradient {n}: {rel} of "
                                 f"max(|grad|, 1e-3 max|grads|)")
    errs["grad_rel"] = worst
    errs["state"] = 0.0
    for n, t in sr.items():
        if t.is_floating_point():
            e = float((sc[n] - t).abs().max()) / max(1.0,
                                                     float(t.abs().max()))
            errs["state"] = max(errs["state"], e)
            if e > TOL:
                raise AssertionError(f"card vs CPU updated {n}: {e}")
    log(f"[step-check] B=2, dropout 0, injected permutations: losses card "
        f"{lc} vs CPU {lr}; worst relative errors {errs} (card "
        f"{tc:.2f} s, CPU {tr:.2f} s per step)")
    return dict(errs, losses_card=lc, losses_cpu=lr)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def entry_phase():
    """train_simple_policy.main on the card as a user starts it:
    ENTRY_STEPS steps of run_training, each host batch made in series with
    the steps, a log line after step ENTRY_STEPS / 2 and after the last
    (each reads the losses, a sync). Launch counters read against PER_STEP;
    the end-to-end rate is the clouds of the second half over the time
    between the two lines."""
    half = ENTRY_STEPS // 2
    cfg = train_config("TRAIN.num_train_steps", str(ENTRY_STEPS),
                       "TRAIN.log_steps", str(half))
    logger = logging.getLogger("robot3dlotus_tpu_torch.train")
    handler, level = _Records(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    try:
        trainer = train_simple_policy.main(cfg)
        torch.cuda.synchronize()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    total_s = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    if trainer.optimizer.count != ENTRY_STEPS:
        raise AssertionError(f"entry point ran {trainer.optimizer.count} "
                             f"steps, expected {ENTRY_STEPS}")
    del trainer
    for k, per in PER_STEP.items():
        if launches[k] != per * ENTRY_STEPS:
            raise AssertionError(f"{k}: {launches[k]} launches in "
                                 f"{ENTRY_STEPS} entry-point steps, expected "
                                 f"{per} per step")
    lines = [r for r in handler.records if r.getMessage().startswith("step ")]
    if len(lines) != 2:
        raise AssertionError(f"entry point logged {len(lines)} step lines")
    for r in lines:
        values = [float(kv.split("=")[1]) for kv in
                  r.getMessage().split(": ", 1)[1].split(", ")]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"entry point: {r.getMessage()}")
    clouds = half * int(cfg.TRAIN.train_batch_size)
    span_s = lines[1].created - lines[0].created
    out = {"steps": ENTRY_STEPS, "wall_s": total_s,
           "second_half_s": span_s,
           "clouds_per_s": clouds / span_s,
           "step_ms": span_s * 1e3 / half,
           "log": [r.getMessage() for r in lines]}
    log(f"[entry] train_simple_policy.main, {ENTRY_STEPS} steps in "
        f"{total_s:.2f} s (build included); steps {half + 1}-{ENTRY_STEPS} "
        f"{out['step_ms']:.1f} ms each with their host batches, "
        f"{out['clouds_per_s']:.2f} clouds/s end to end")
    for m in out["log"]:
        log(f"[entry]   {m}")
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    cuda_lib.build()
    cuda_lib.library()
    log(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    actioner = Actioner(CONFIG, cli_opts=CLI_OPTS, device="cuda", seed=0)
    log(f"[serving] release-width Actioner built in "
        f"{time.perf_counter() - t0:.2f} s")
    observations = [synthetic_observation(100 + i) for i in range(4)]

    actioner.rng = np.random.default_rng(0)
    captured = capture_main_path(
        lambda: actioner.predict(**requests(observations)[0]))
    captured_batch = capture_main_path(
        lambda: actioner.predict_batch(requests(observations)))
    rows, detail = kernel_phase(captured, captured_batch)
    serving = serving_phase(actioner, observations)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    breakdown = breakdown_phase(actioner, observations, out_dir)
    ref = reference_phase(actioner, observations[0])
    del actioner

    t0 = time.perf_counter()
    trainer, batches, _ = build_trainer(train_config(), SPEC, device="cuda")
    host, data_ms = host_batches(batches, 1 + TRAIN_STEPS + PROFILE_STEPS)
    log(f"[train-capture] trainer built and {len(host)} host batches of "
        f"{trainer_batch(host)} clouds made in "
        f"{time.perf_counter() - t0:.1f} s (host ms per batch: "
        f"{[round(t) for t in data_ms]})")
    captured = capture(lambda: trainer.step(batch_to_device(host[0], "cuda")),
                       TRAIN_SITES)
    training, train_launches = training_phase(trainer, host[1:], out_dir)
    training["host_batch_ms"] = data_ms
    del trainer
    train_rows, train_detail = train_kernel_phase(captured)
    del captured
    step_check = step_check_phase(host[0])
    entry = entry_phase()

    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "kernels": rows, "calls": detail,
                   "serving": serving, "breakdown": breakdown,
                   "reference_max_diff": ref, "training": training,
                   "train_kernels": train_rows,
                   "train_calls": train_detail, "step_check": step_check,
                  "entry": entry},
                  f, indent=1)
    # K1-K4 as the serving run launched them, K5-K8 as the training run
    # did; launches_by_path has both runs' counts for every kernel
    rows.update(train_rows)
    kernels = [dict(name=k, route="cuda", source=KERNELS[k][0],
                    replaces=KERNELS[k][1],
                    launches=(serving["launches"] if k in PER_FORWARD
                              else train_launches)[k],
                    launches_by_path={"serving": serving["launches"][k],
                                      "training": train_launches[k]},
                    **rows[k])
               for k in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
