#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card (an H100).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):
  1. build   the hand-written kernels K1-K10 from robot3dlotus_tpu_torch/csrc
             (one nvcc per source, all started together) and load them;
  2. capture one `Actioner.predict` at the release width (4096 points) and
             one `predict_batch` of 4 with recorders on the kernel call
             sites, keeping every kernel input the main path produces;
  3. kernels hold each captured call against the kernel's plain PyTorch
             version on the card (|kernel - plain| <= 1e-4 * max(1,
             max|plain|): fp32 on both sides, other summation orders; K4
             bit-equal, its unpool calls with sentinel rows), and time the
             B=1 calls: kernel, plain version and, where one PyTorch call
             computes the same function, that call (CUDA events: median of
             21 rounds of 10 back-to-back calls, after 3 warm-up calls);
             K4's calls also read their device time from the profiler;
             K2 (3xTF32 on the tensor cores) is also held bit-equal across
             two launches, timed on the profiler, beside an im2col gather
             + matmul (two PyTorch calls, for reference) and its bounds at
             the TF32 and the fp32 SIMT rates, with each map's shares of
             live (row, tap) pairs, of (64-row tile, tap) pairs a
             whole-tap skip keeps and of pairs K2 multiplies;
  4. serving launch counters to 0, then 4 `predict` requests and one
             `predict_batch` of the same 4 observations (4 cameras of
             256 x 256 xyz/rgb, seeded tabletop scenes), counters read: each
             kernel must have launched its per-forward count 5 times; batch
             and sequential actions must agree; p50 request latency printed;
  5. breakdown host preprocessing vs device forward per request, and a
             torch.profiler window over 3 forwards: device time by kernel,
             device launches per forward and the device's idle share
             (profile_forward.txt in the output directory);
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
             versions: K5's out, row logsumexp and packed keep bits (the
             bits bit-equal to the PyTorch Philox generator, their keep
             fraction within 5 binomial sigmas of 1 - rate), K6 on K5's
             outputs and the captured cotangent, K5 at rate 0 against K1,
             K7 at the CPE and the stem shapes, K8 (sentinel rows
             dropped), and the conv's dx (K8 onto voxel owners, then K2
             with the mirrored weight) against the exact adjoint (autograd
             of subm_conv_plain) on every row; |kernel - plain|
             <= 1e-4 * max|plain| (gradients are far below 1); K4 on the
             step's 8 calls at B = 32, bit-equal; time K4-K8 per training
             step (CUDA events, median of 5 rounds of 2 calls after a
             warm-up call; K5/K6 also their profiler device time) beside
             the SDPA calls (the profiler names of the SDPA kernels
             logged); K2's 9 forward and 9 mirrored dx launches and K7,
             each bit-equal across two launches, timed (events and
             profiler) against their plain versions and their TF32 and
             fp32 SIMT bounds;
 10. step-check one step at dropout 0 with injected order permutations on
             each of CHECK_SLICES B = 2 slices of the same batch, the same
             weights, on the card and on the CPU (plain versions): losses,
             every updated parameter and running statistic, every
             gradient; a gradient that a max reduction picking different
             rows on the two devices (a near tie) can reach is not held on
             that slice, and every gradient must be held on some slice; at
             a leaky-ReLU pre-activation within 1e-4 max|z| of the kink
             (a tie) the CPU follows the card's branch;
 11. entry     train_simple_policy.main on the card for ENTRY_STEPS steps
             (launch counters to 0 before, read after against the per-step
             counts; logged losses finite); the end-to-end training rate,
             host batches included, over the second half.
Then the 3D-LOTUS++ motion planner (release motion_planner_ptv3.yaml,
seeded weights) behind the ground-truth pipeline (robot_pipeline_gt.yaml):
 12. mp-capture   one GroundtruthRobotPipeline.predict on a synthetic
             observation with gt_mask images (4096 points), recorders on the
             K9 call sites (the stage-0 entry sort, the categorical stem)
             and the convs (K2, held against its plain version in 14);
 13. mp-serving   launch counters to 0, 4 pipeline requests of one episode,
             each running the motion planner, counters read against
             MP_PER_FORWARD; MotionPlannerEngine.predict p50 with the host
             prep (GT vision, labels, text) apart from the device forward;
             a profiler window over 3 forwards, device launches per forward
             among its numbers (profile_mp_forward.txt
             beside the other outputs); the card's trajectory logits against
             the same weights on the CPU (1e-3 * max(1, |ref|)), decoded
             actions finite;
 14. mp-kernels   K9 on every captured call bit-equal to its plain version
             (device time from the profiler beside the event time);
             K10 on the captured stem index with seeded cotangents at C = 5
             and C = 20 (<= 1e-4 * max|plain|); times, bounds, library calls
             (at the forward's B = 1 and, from one captured training step,
             at B = 32); K2 on the request's 9 captured calls (within
             1e-4 * max(1, max|plain|), bit-equal across two launches);
 15. mp-train     train_motion_planner's trainer on synthetic_motion, B = 32
             clouds x 4096 points, release dropout: 5 steps with launch
             counts checked per step (MP_PER_STEP), step p50, clouds/s, peak
             memory, a profiler window (profile_mp_train.txt); then one
             more step captured, whose 9 convs hold and time K2 (forward
             and mirrored dx) and K7 per motion-planner step as phase 9;
 16. mp-step-check  phase 10 for the motion planner, on MP_CHECK_SLICES
             slices;
 17. mp-entry     train_motion_planner.main on the card for MP_ENTRY_STEPS
             steps, launch counts checked, logged losses finite.
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
import yaml

from robot3dlotus_tpu_torch.configs import get_config
from robot3dlotus_tpu_torch.eval.actioner import Actioner
from robot3dlotus_tpu_torch.eval.common import parse_code
from robot3dlotus_tpu_torch.eval.robot_pipeline import (
    GroundtruthRobotPipeline, MotionPlannerEngine, _plan_action_name)
from robot3dlotus_tpu_torch.eval.synthetic_obs import (TASKVAR,
                                                       synthetic_observation)
from robot3dlotus_tpu_torch.models import layers
from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.models.layers import Randomness
from robot3dlotus_tpu_torch.models.motion_planner import (compute_mp_loss,
                                                          decode_mp_actions)
from robot3dlotus_tpu_torch.models.simple_policy import compute_loss
from robot3dlotus_tpu_torch.ops import (attention, conv, cuda_lib, gather,
                                        patching, pooling, sparse_conv, stem)
from robot3dlotus_tpu_torch.train.driver import build_trainer
from robot3dlotus_tpu_torch.train.optim import build_optimizer
from robot3dlotus_tpu_torch.train import (train_motion_planner,
                                          train_simple_policy)
from robot3dlotus_tpu_torch.train.train_simple_policy import SPEC
from robot3dlotus_tpu_torch.train.trainer import Trainer, batch_to_device

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "robot3dlotus_tpu_torch", "configs", "rlbench",
                      "simple_policy_ptv3.yaml")
MP_CONFIG = os.path.join(os.path.dirname(CONFIG), "motion_planner_ptv3.yaml")
GT_CONFIG = os.path.join(os.path.dirname(CONFIG), "robot_pipeline_gt.yaml")
CLI_OPTS = ["TRAIN_DATASET.instr_embed_file", "None"]
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12    # H100 SXM data sheet, fp32 outside tensor cores
TF32_FLOPS_PER_S = 494.7e12  # H100 SXM data sheet, dense TF32 tensor cores
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
    "gather_rows_smallc": ("robot3dlotus_tpu_torch/csrc/gather_smallc.cu",
                           "robot3dlotus_tpu/ops/pallas_gather.py:353"),
    "scatter_rows_smallc_add": (
        "robot3dlotus_tpu_torch/csrc/gather_smallc.cu",
        "robot3dlotus_tpu/ops/pallas_gather.py:272"),
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
# K4 4 shuffled child entry sorts, 4 unpools; K9 the stage-0 entry sort of
# the 7-channel input (its input is data: no K10); K7 9 CPE + the stem; K8
# the backward of every K4 call and the owner sum of each of the 9 conv dx
PER_STEP = {"subm_conv": 18, "stem_conv": 1, "gather_rows": 8,
            "gather_rows_smallc": 1, "scatter_rows_smallc_add": 0,
            "patch_attention_dropout": 9, "patch_attention_dropout_bwd": 9,
            "conv_weight_grad": 10, "scatter_rows_add": 17,
            "patch_attention": 0}
# the motion planner: its trainer on the synthetic motion store (no action
# embedding cache: the crc32 embeddings)
MP_TRAIN_OPTS = ["TRAIN_DATASET.data_dir", "synthetic_motion",
                 "TRAIN_DATASET.action_embed_file", "None",
                 "TRAIN_DATASET.taskvar_file", "None"]
MP_REQUESTS = 4
MP_ENTRY_STEPS = 4
# launches per motion-planner forward: 9 Blocks; 4 unpools; K9 for the
# stage-0 entry sort (C = 4) and the categorical stem (C = 5, M = N * 125),
# whose product is a plain matmul (no K3)
MP_PER_FORWARD = {"patch_attention": 9, "subm_conv": 9, "stem_conv": 0,
                  "gather_rows": 4, "gather_rows_smallc": 2,
                  "scatter_rows_smallc_add": 0, "conv_weight_grad": 0,
                  "scatter_rows_add": 0, "patch_attention_dropout": 0,
                  "patch_attention_dropout_bwd": 0}
# per motion-planner training step: as the policy's, with K9 twice (entry
# sort and stem), no K3, K7 for the 9 CPE only (the stem's dW is autograd
# of its product) and no K10 (the stem gathers data)
MP_PER_STEP = dict(PER_STEP, stem_conv=0, gather_rows_smallc=2,
                   conv_weight_grad=9)
TRAIN_KERNELS = ("patch_attention_dropout", "patch_attention_dropout_bwd",
                 "conv_weight_grad", "scatter_rows_add")
# the step check's order permutations: stage 0 and the four poolings
CHECK_PERMS = [[2, 0, 3, 1], [1, 3, 0, 2], [3, 2, 1, 0], [0, 2, 1, 3],
               [2, 3, 0, 1]]
GRAD_TOL = 1e-3   # card vs CPU gradients of the whole step, per tensor
# B = 2 slices per step check, ~3-6 s of CPU each
CHECK_SLICES = 6
MP_CHECK_SLICES = 6
# leaky-ReLU decisions the CPU run may take from the card: each at |z| <=
# KINK_TOL max|z| (the devices' rows differ by ~1e-6 relative), at most
# MAX_KINKS per slice
KINK_TOL = 1e-5
MAX_KINKS = 4
# device kernels of a training step by name, first match wins
DEVICE_GROUPS = [
    ("K9/K10 small-C gather", ("gather_smallc_kernel",
                               "scatter_smallc_add_kernel")),
    ("K7 conv_weight_grad", ("wgrad_", "sum_splits")),
    ("K2 subm_conv", ("subm_conv",)),
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


# K2 / K7: the kernel each wrapper call launches once, and the other
# kernels of the same call (device_ms)
K2_PROFILE = ("subm_conv_kernel", ("subm_conv_reduce",))
K7_PROFILE = (("wgrad_tc_kernel", "wgrad_taps_kernel"),
              ("wgrad_compact", "sum_splits"))


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
                 (gather, "gather_rows", "gather_rows")]
TRAIN_SITES = [(layers, "patch_attention_dropout", "attention"),
               (sparse_conv, "subm_conv", "subm_conv"),
               (sparse_conv, "stem_conv", "stem_conv"),
               (pooling, "gather_rows", "gather_rows"),
               (gather, "gather_rows", "gather_rows"),
               (patching, "gather_rows", "gather_rows")]
# K9: the entry sort (gather.permute_rows_any) and the categorical stem
SMALLC_SITES = [(gather, "gather_rows_smallc", "gather_rows_smallc"),
                (sparse_conv, "gather_rows_smallc", "gather_rows_smallc")]
# the motion planner's CPE convs (K2, K7)
MP_CONV_SITES = [(sparse_conv, "subm_conv", "subm_conv")]


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

def _bound(nbytes, flops, flops_per_s=FP32_FLOPS_PER_S):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_b, t_f) * 1e3, t_b, t_f


def _sdpa(q, k, v, kv, scale):
    mask = kv[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale)


def _named(events, names):
    names = (names,) if isinstance(names, str) else names
    return [e for e in events if any(n in e.key for n in names)]


def device_ms(fn, name, reps=10, windows=3, also=()):
    """Device time per call of fn, over `reps` calls in one torch.profiler
    window (CUPTI), after a warm-up call: the device's share of a call
    whose CUDA-event time (cuda_ms) includes its host path. `name` (a
    string or a tuple) matches the profiler name of the kernel that each
    call launches once; `also` other kernels of the same call (a
    compaction, a split reduction), whose time is added. Divides by the
    launches of `name` the profiler recorded: in a process that opens many
    windows it sometimes records only some of them, or none, and then a new
    window is opened, up to `windows`; None (not measured) if none recorded
    one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = _device_events(prof.key_averages())
        launches = sum(e.count for e in _named(events, name))
        if launches:
            timed = _named(events, (name,) + tuple(also)
                           if isinstance(name, str) else name + tuple(also))
            return sum(_dev_us(e) for e in timed) / 1e3 / launches
    return None


def _total(values):
    """The sum, or None (not measured) if any value is None."""
    values = list(values)
    return None if None in values else sum(values)


# the row gathers: wrapper, plain version, the kernel's profiler name
GATHERS = {"gather_rows": (gather.gather_rows, gather.gather_rows_plain,
                           "gather_rows_kernel"),
           "gather_rows_smallc": (gather.gather_rows_smallc,
                                  gather.gather_rows_smallc_plain,
                                  "gather_smallc_kernel")}


def _padded_gather(x, idx):
    """The library yardstick of a row gather with sentinel rows: one
    torch.gather on x with a zero row appended, every index outside [0, N)
    sent to it; pad and int64 expanded index built here, outside the timed
    call."""
    B, N, D = x.shape
    x_pad = torch.cat([x, x.new_zeros(B, 1, D)], 1)
    sel = torch.where((idx >= 0) & (idx < N), idx, N).long()
    sel = sel[..., None].expand(-1, -1, D)
    return lambda: torch.gather(x_pad, 1, sel)


def check_gather(kernel, args, timing=None):
    """K4 or K9 on one captured call: bit-equal to its plain version (both
    only copy) and its sentinel rows (index outside [0, N)) counted; with
    `timing` (cuda_ms keywords), the kernel's event and profiler device
    times, the plain version's and the library yardstick's times, and the
    bound (x and the indices read once, the output written once)."""
    x, idx = args
    fn, plain_fn, name = GATHERS[kernel]
    B, N, D = x.shape
    run = lambda: fn(x, idx)  # noqa: E731
    plain = lambda: plain_fn(x, idx)  # noqa: E731
    got, want = run(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{kernel} {[B, N, D]} M={idx.shape[1]}: not "
                             "bit-equal to its plain version")
    out = {"shape": [B, N, D, idx.shape[1]], "index": str(idx.dtype),
           "max_abs_err": 0.0, "max_rel_err": 0.0,
           "sentinel_rows": int(((idx < 0) | (idx >= N)).sum())}
    if timing is None:
        return out
    bound_ms, t_b, t_f = _bound(4 * (x.numel() + got.numel()) +
                                idx.numel() * idx.element_size(), 0)
    return {**out, "ms": cuda_ms(run, **timing),
            "device_ms": device_ms(run, name),
            "plain_ms": cuda_ms(plain, **timing),
            "library_ms": cuda_ms(_padded_gather(x, idx), **timing),
            "bound_ms": bound_ms, "bytes_s": t_b, "flops_s": t_f}


def _twice(run, what):
    """Two launches on the same inputs, bit-equal (no atomics, a fixed
    summation order); returns the first result."""
    a, b = run(), run()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: two launches on the same inputs "
                             "differ")
    return a


def _im2col(x, idx, ok, w):
    """For reference only, K2's product as two PyTorch calls: a dense
    gather of all K taps (a zero row appended, dead links sent to it) and
    one matmul, no bias; the padded x and the index are built here, outside
    the timed call."""
    B, N, Cin = x.shape
    K, _, Cout = w.shape
    x_pad = torch.cat([x, x.new_zeros(B, 1, Cin)], 1)
    sel = torch.where(ok, idx.long(), N).reshape(B, N * K, 1).expand(
        -1, -1, Cin)
    w2 = w.reshape(K * Cin, Cout)
    return lambda: torch.matmul(
        torch.gather(x_pad, 1, sel).reshape(B, N, K * Cin), w2)


def _conv_bytes(x, idx, w, cout):
    """K2's bytes: x, the map (idx and ok), W and bias read once, the
    output written once."""
    B, N, _ = x.shape
    return 4 * (x.numel() + w.numel() + B * N * cout + cout) + \
        5 * idx.numel()


def link_shares(ok, tile_rows=conv.CONV_ROWS, group=16, skip_rows=64):
    """Work shares of one conv's (B, N, K) map. 'live': the (row, tap)
    pairs with a link, of all B N K; 'tile_kept': the (skip_rows-row tile,
    tap) pairs in which some row has a link, of all such pairs (what a
    whole-tap skip per tile keeps, as the earlier SIMT K2 did);
    'compacted': the (row, tap) pairs K2 multiplies, of all B N K: per
    (tile_rows-row tile, tap) its live rows rounded up to `group` (the
    mma's m)."""
    B, N, K = ok.shape
    okc = ok.to(torch.int32)

    def per_tile(rows):
        t = F.pad(okc, (0, 0, 0, -N % rows))
        return t.reshape(B, -1, rows, K).sum(2)

    kept = per_tile(skip_rows) > 0
    comp = -(-per_tile(tile_rows) // group) * group
    total = max(B * N * K, 1)
    return {"live": int(okc.sum()) / total,
            "tile_kept": int(kept.sum()) / max(kept.numel(), 1),
            "compacted": int(comp.sum()) / total}


def _shares(results):
    """The work shares (link_shares) of several calls, weighted by
    their (row, tap) pairs."""
    pairs = sum(r["pairs"] for r in results)
    return {k: sum(r["shares"][k] * r["pairs"] for r in results) / pairs
            for k in results[0]["shares"]}


def check_conv(args, timed=True):
    """K2 on one captured forward call: within TOL * max(1, max|plain|)
    of its plain version, bit-equal across two launches, its map's work
    shares (link_shares); if `timed`, its event and profiler device
    times, the plain version's, the im2col gather + matmul reference (two
    PyTorch calls, no single one computes K2), and its bounds: bytes
    against 3 x the live-link flops at the TF32 rate (its products run on
    the tensor cores as 3xTF32), the fp32 SIMT bound beside it."""
    x, idx, ok, w, bias = args
    run = lambda: conv.subm_conv(x, idx, ok, w, bias)  # noqa: E731
    plain = lambda: conv.subm_conv_plain(x, idx, ok, w, bias)  # noqa
    B, N, Cin = x.shape
    K, _, Cout = w.shape
    shape = [B, N, K, Cin, Cout]
    got = _twice(run, f"K2 {shape}")
    want = plain()
    err = float((got - want).abs().max())
    scale_ref = max(1.0, float(want.abs().max()))
    if not bool(torch.isfinite(got).all()) or err > TOL * scale_ref:
        raise AssertionError(f"K2 {shape}: max |kernel - plain| = {err} > "
                             f"{TOL} * {scale_ref}")
    out = {"shape": shape, "max_abs_err": err, "max_rel_err": err / scale_ref,
           "shares": link_shares(ok), "pairs": B * N * K,
           "tap_splits": conv.conv_tap_splits(B, N, K, Cout)}
    if not timed:
        return out
    nbytes = _conv_bytes(x, idx, w, Cout)
    flops = 2 * Cin * Cout * int(ok.sum())      # this cloud's live links
    bound_ms, t_b, t_f = _bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
    return {**out, "ms": cuda_ms(run),
            "device_ms": device_ms(run, K2_PROFILE[0], also=K2_PROFILE[1]),
            "plain_ms": cuda_ms(plain), "library_ms": None,
            "im2col_matmul_ms": cuda_ms(_im2col(x, idx, ok, w)),
            "bound_ms": bound_ms, "bytes_s": t_b, "flops_s": t_f,
            "fp32_bound_ms": _bound(nbytes, flops)[0]}


def log_conv(tag, label, r):
    """One line per K2 or K7 call: shape, shares and, if timed, times."""
    sh = r["shares"]
    times = "" if "ms" not in r else (
        f"; {r['ms']:.4f} ms (device {r['device_ms']}; plain "
        f"{r['plain_ms']:.4f}"
        + (f", im2col gather + matmul {r['im2col_matmul_ms']:.4f}"
           if "im2col_matmul_ms" in r else "")
        + f"; bound {r['bound_ms']:.4f} TF32, {r['fp32_bound_ms']:.4f} "
        f"fp32 SIMT)")
    log(f"[{tag}] {label} {r['shape']}: live (row, tap) pairs "
        f"{sh['live']:.4f}, (64-row tile, tap) pairs a whole-tap skip keeps "
        f"{sh['tile_kept']:.4f}, pairs multiplied {sh['compacted']:.4f}; "
        f"max_abs_err {r['max_abs_err']:.3g}{times}")


def check_call(kernel, args, timed=True):
    """One captured call: error vs plain and, if `timed`, times and
    bound."""
    if kernel == "gather_rows":
        return check_gather(kernel, args, {} if timed else None)
    if kernel == "subm_conv":
        return check_conv(args, timed)
    if kernel == "patch_attention":
        q, k, v, kv, scale = args
        run = lambda: attention.patch_attention(q, k, v, kv, scale)  # noqa
        plain = lambda: attention.patch_attention_plain(q, k, v, kv, scale)  # noqa
        library = lambda: _sdpa(q, k, v, kv, scale)  # noqa: E731
        G, H, P, Dh = q.shape
        shape = [G, H, P, Dh]
        nbytes = 4 * 4 * q.numel() + kv.numel()
        flops = 4 * G * H * P * P * Dh
    elif kernel == "stem_conv":
        x, idx, ok, w = args
        run = lambda: stem.stem_conv(x, idx, ok, w)  # noqa: E731
        plain = lambda: stem.stem_conv_plain(x, idx, ok, w)  # noqa
        library = None
        B, N, Cin = x.shape
        K, _, Cout = w.shape
        shape = [B, N, K, Cin, Cout]
        nbytes = 4 * (x.numel() + w.numel() + B * N * Cout + Cout) + \
            5 * idx.numel()
        flops = 2 * Cin * Cout * int(ok.sum())      # this cloud's live links
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
    k2 = [r for r in detail if r["name"] == "subm_conv"]
    k2_b1 = [r for r in k2 if "ms" in r]
    for r in k2_b1:
        log_conv("kernels", "K2 per forward, call", r)
    rows["subm_conv"].update(
        fp32_bound_ms=sum(r["fp32_bound_ms"] for r in k2_b1),
        device_ms=_total(r["device_ms"] for r in k2_b1),
        im2col_matmul_ms=sum(r["im2col_matmul_ms"] for r in k2_b1),
        shares=_shares(k2_b1),
        batch4_shares=_shares([r for r in k2 if "ms" not in r]))
    log(f"[kernels] K2 per forward: {rows['subm_conv']['ms']:.4f} ms "
        f"(device {rows['subm_conv']['device_ms']}; plain "
        f"{rows['subm_conv']['plain_ms']:.4f}; im2col gather + matmul "
        f"{rows['subm_conv']['im2col_matmul_ms']:.4f}; bound "
        f"{rows['subm_conv']['bound_ms']:.4f} TF32, "
        f"{rows['subm_conv']['fp32_bound_ms']:.4f} fp32 SIMT); shares "
        f"{rows['subm_conv']['shares']}")
    rows["gather_rows"]["device_ms"] = _total(
        r["device_ms"] for r in detail if r["name"] == "gather_rows"
        and "device_ms" in r)
    log_gathers("kernels", "K4 per forward", [r for r in detail
                                              if r["name"] == "gather_rows"])
    rows["gather_rows"]["host_us"] = host_split(*captured["gather_rows"][0])
    if not any(r["sentinel_rows"] for r in detail
               if r["name"] == "gather_rows"):
        # no captured call had one: hold a seeded call that does
        gen = torch.Generator(device="cuda").manual_seed(21)
        x = torch.randn(1, 512, 64, generator=gen, device="cuda")
        idx = torch.randint(0, 600, (1, 1024), generator=gen, device="cuda")
        r = dict(check_gather("gather_rows", (x, idx)), name="gather_rows",
                 seeded=True)
        detail.append(r)
        log_gathers("kernels", "K4 seeded call", [r])
    return rows, detail


def host_split(x, idx, rounds=5, calls=2000):
    """Host microseconds per call (host clock, median of `rounds` rounds of
    `calls` back-to-back calls) of K4's wrapper and of torch.gather on the
    padded x, and of the two parts of the wrapper that no Python wrapper
    avoids: the output allocation alone, and the ctypes call of the C entry
    point (with its launch) alone on a preallocated output."""
    B, N, D = x.shape
    M = idx.shape[1]
    out = x.new_empty(B, M, D)
    entry = cuda_lib.library().r3dl_gather_rows
    args = (x.data_ptr(), idx.data_ptr(), out.data_ptr(), B, N, M, D,
            int(idx.dtype == torch.int64))
    parts = {"wrapper": lambda: gather.gather_rows(x, idx),
             "torch.gather": _padded_gather(x, idx),
             "allocation": lambda: x.new_empty(B, M, D),
             "ctypes call and launch": lambda: entry(
                 *args, cuda_lib.current_stream())}
    times = {k: [] for k in parts}
    for _ in range(rounds):
        for k, fn in parts.items():
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times[k].append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"[kernels] K4 host path per call, {[B, N, D, M]} (us, host clock, "
        f"median of {rounds} rounds of {calls} calls): wrapper "
        f"{med['wrapper']:.2f}, torch.gather {med['torch.gather']:.2f}; "
        f"of the wrapper: allocation {med['allocation']:.2f}, ctypes call "
        f"and launch {med['ctypes call and launch']:.2f}")
    return med


def log_gathers(tag, label, results):
    """One line per K4 / K9 call: shape, index type, sentinel rows and, if
    timed, event time beside the profiler's device time."""
    for r in results:
        dev = "not measured" if r.get("device_ms") is None else \
            f"{r['device_ms']:.4f} ms"
        times = "" if "ms" not in r else (
            f", {r['ms']:.4f} ms by events, {dev} on the device (plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f})")
        log(f"[{tag}] {label}: [B, N, D, M] {r['shape']} {r['index']}, "
            f"{r['sentinel_rows']} sentinel rows{times}")


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
    kernels = _device_ops(events, 3)
    busy_ms = sum(k[1] for k in kernels)
    with open(os.path.join(out_dir, "profile_forward.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    fwd_p50 = float(np.median(fwd_ms))
    out = {"host_prep_ms_p50": float(np.median(prep_ms)),
           "forward_ms_p50": fwd_p50,
           "profiled_forward_wall_ms": wall_ms / 3,
           "device_busy_ms_per_forward": busy_ms,
           "device_launches_per_forward": _device_launches(events, 3),
           "device_idle_share": 1.0 - busy_ms / fwd_p50,
           "top_device_ops": [{"name": k[0][:80], "ms": k[1], "count": k[2]}
                              for k in kernels[:15]]}
    log(f"[breakdown] host prep p50 {out['host_prep_ms_p50']:.2f} ms, "
        f"device forward p50 {fwd_p50:.2f} ms (profiled: "
        f"{out['profiled_forward_wall_ms']:.2f} ms wall); device busy "
        f"{busy_ms:.2f} ms per forward in "
        f"{out['device_launches_per_forward']:.2f} device launches (kernels, "
        f"memcpy, memset), idle share of the unprofiled forward "
        f"{out['device_idle_share']:.3f}")
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


def _dev_us(e):
    return getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0)


def _device_events(events):
    """The device-side events (kernels, memcpy/memset) of a profile; the
    CPU-side aten ops that launched them report the same time again."""
    return [e for e in events
            if str(e.device_type).endswith("CUDA") and _dev_us(e)]


def _device_ops(events, n):
    """(name, device ms per unit, count per unit) of the device-side
    events of a profile over n units, largest first."""
    return sorted(((e.key, _dev_us(e) / 1e3 / n, e.count // n)
                   for e in _device_events(events)), key=lambda t: -t[1])


def _device_launches(events, n):
    """Device launches (kernels, memcpy, memset) per unit of a profile over
    n units."""
    return sum(e.count for e in _device_events(events)) / n


def _group_device_ops(ops):
    """{DEVICE_GROUPS label or 'other': {'ms', 'count'}} of _device_ops'
    output, largest first."""
    groups = {}
    for name, ms, count in ops:
        g = next((label for label, keys in DEVICE_GROUPS
                  if any(k in name for k in keys)), "other")
        acc = groups.setdefault(g, [0.0, 0])
        acc[0] += ms
        acc[1] += count
    return {g: {"ms": v[0], "count": v[1]}
            for g, v in sorted(groups.items(), key=lambda t: -t[1][0])}


def training_phase(trainer, batches, out_dir, per_step=PER_STEP,
                   profile_file="profile_train.txt", tag="training"):
    """5 counted steps (launches against per_step), then a profiler window
    over 2 more."""
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
        log(f"[{tag}] step {i + 1}: {losses[-1]}")
    launches = dict(cuda_lib.LAUNCHES)
    for k, per in per_step.items():
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
    with open(os.path.join(out_dir, profile_file), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=80))
    busy = sum(o[1] for o in ops)
    p50 = float(np.median(step_ms))
    out = {"step_ms": step_ms, "step_ms_p50": p50,
           "clouds_per_s": trainer_batch(batches) * 1e3 / p50,
           "peak_mem_gib": peak / 2 ** 30, "losses": losses,
           "launches_per_step": {k: launches[k] / TRAIN_STEPS
                                 for k in launches},
           "profiled_step_wall_ms": wall_ms / PROFILE_STEPS,
           "device_busy_ms_per_step": busy,
           "device_idle_share": 1.0 - busy / p50,
           "device_ms_by_group": _group_device_ops(ops),
           "top_device_ops": [{"name": o[0][:80], "ms": o[1], "count": o[2]}
                              for o in ops[:20]]}
    log(f"[{tag}] B={trainer_batch(batches)} x "
        f"{batches[0]['pc_fts'].shape[1]} points: step p50 {p50:.1f} ms "
        f"(all {[round(t, 1) for t in step_ms]}), "
        f"{out['clouds_per_s']:.1f} clouds/s, peak memory "
        f"{out['peak_mem_gib']:.2f} GiB")
    log(f"[{tag}] launches per step {out['launches_per_step']}")
    log(f"[{tag}] device busy {busy:.1f} ms per step (profiled wall "
        f"{out['profiled_step_wall_ms']:.1f} ms), idle share of the "
        f"unprofiled step {out['device_idle_share']:.3f}")
    for g, v in out["device_ms_by_group"].items():
        log(f"[{tag}]   {v['ms']:.3f} ms x{v['count']}  {g}")
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


def _timed_tc(run, plain, library, nbytes, flops, name, also=()):
    """_timed for a kernel whose products run on the tensor cores as
    3xTF32: bound_ms is the bytes against 3 * flops at the TF32 rate;
    fp32_bound_ms the bytes against flops at the fp32 SIMT rate (the
    bound of the SIMT kernels' rows); device_ms from the profiler (`name`
    and `also` as device_ms takes them)."""
    bound_ms, t_b, t_f = _bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
    return dict(_timed(run, plain, library, nbytes, flops),
                bound_ms=bound_ms, bytes_s=t_b, flops_s=t_f,
                fp32_bound_ms=_bound(nbytes, flops)[0],
                device_ms=device_ms(run, name, reps=4, also=also))


def _kernel_names(fn):
    """The device kernels one call of fn launches (profiler names)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in _device_events(prof.key_averages())})


def check_attention_train(call, log_sdpa=False):
    """K5 and K6 on one captured call: K5's bits against the PyTorch
    Philox mask and their keep fraction, K5 at rate 0 against K1, K5's
    (out, lse, bits) against its plain version, K6 on K5's outputs and the
    captured cotangent against its plain version; times beside the SDPA
    forward (dropout_p) and backward on the same inputs."""
    (q, k, v, kv, scale, rate, seed), g = call
    G, H, P, Dh = q.shape
    run5 = lambda: attention.patch_attention_dropout_fwd(  # noqa: E731
        q, k, v, kv, scale, rate, seed)
    plain5 = lambda: attention.patch_attention_dropout_fwd_plain(  # noqa
        q, k, v, kv, scale, rate, seed)
    out, lse, bits = run5()
    keep = attention.philox_keep_mask(seed, G, H, P, rate, q.device)
    if not torch.equal(bits, attention.pack_keep_bits(keep)):
        raise AssertionError(f"K5's bits {[G, H, P, Dh]} differ from "
                             "philox_keep_mask")
    n = keep.numel()
    frac = float(keep.float().mean())
    del keep
    if abs(frac - (1 - rate)) > 5 * math.sqrt(rate * (1 - rate) / n):
        raise AssertionError(f"keep fraction {frac} at rate {rate}")
    e0 = _err(attention.patch_attention_dropout(q, k, v, kv, scale, 0.0, 0),
              attention.patch_attention(q, k, v, kv, scale), "K5 rate 0")
    p_out, p_lse, _ = plain5()
    e5 = _err(out, p_out, f"K5 out {[G, H, P, Dh]}")
    # a patch with no valid key has lse = -1e9 (+ log P, below fp32's
    # resolution there): equal; the others within the bar
    live = kv.any(-1)
    e_lse = _err(lse[live], p_lse[live], f"K5 lse {[G, H, P, Dh]}")
    if not torch.equal(lse[~live], p_lse[~live]):
        raise AssertionError("K5 lse of a patch with no valid key")
    del p_out, p_lse
    run6 = lambda: attention.patch_attention_dropout_bwd(  # noqa: E731
        q, k, v, kv, out, lse, bits, g, scale, rate)
    plain6 = lambda: attention.patch_attention_dropout_bwd_plain(  # noqa
        q, k, v, kv, out, lse, bits, g, scale, rate)
    e6 = max(_err(a, b, f"K6 d{nm} {[G, H, P, Dh]}")
             for a, b, nm in zip(run6(), plain6(), "qkv"))
    mask = kv[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, dropout_p=rate, scale=scale)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                              dropout_p=rate, scale=scale)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        sdpa_out, (qg, kg, vg), g, retain_graph=True)
    if log_sdpa:
        log(f"[train-kernels] SDPA forward kernels {_kernel_names(sdpa)}; "
            f"backward {_kernel_names(sdpa_bwd)}")
    qb = 4 * q.numel()
    side = 4 * (lse.numel() + bits.numel()) + kv.numel()   # lse, bits, kv
    flops = 2 * G * H * P * P * Dh                           # one product
    r5 = dict(_timed_tc(run5, plain5, sdpa, 4 * qb + side, 2 * flops,
                        "attn_drop_fwd"),
              max_abs_err=e5, lse_err=e_lse, rate0_vs_k1_err=e0,
              keep_fraction=frac, shape=[G, H, P, Dh])
    r6 = dict(_timed_tc(run6, plain6, sdpa_bwd, 8 * qb + side, 5 * flops,
                        "attn_drop_bwd"),
              max_abs_err=e6, shape=[G, H, P, Dh])
    return r5, r6


def check_weight_grad(call):
    """K7 on one captured conv or stem call (its x, map and the cotangent
    of its output)."""
    (x, idx, ok, w, *_), g = call
    K, cin, cout = w.shape
    run = lambda: conv.conv_weight_grad(x, idx, ok, g)  # noqa: E731
    plain = lambda: conv.conv_weight_grad_plain(x, idx, ok, g)  # noqa
    shape = list(x.shape[:2]) + [K, cin, cout]
    err = _err(_twice(run, f"K7 {shape}"), plain(), f"K7 {shape}")
    nbytes = 4 * (x.numel() + g.numel() + w.numel()) + 5 * idx.numel()
    return dict(_timed_tc(run, plain, None, nbytes,
                          2 * cin * cout * int(ok.sum()), *K7_PROFILE),
                max_abs_err=err, shape=shape, shares=link_shares(ok),
                pairs=ok.numel(),
                splits=conv.weight_grad_plan(*shape)[0])


def check_conv_dx(call):
    """The conv backward's dx (K8 onto voxel owners, then K2 with the
    mirrored weight) against the exact adjoint (autograd of
    subm_conv_plain) on every row; then the conv's two K2 launches of a
    training step, the forward and the mirrored weight on the owner sums,
    each against its plain version, bit-equal across two launches, and
    timed. Returns the dx row, the K8 result of the owner scatter and the
    two K2 results."""
    (x, idx, ok, w, bias), g = call
    B, N, cin = x.shape
    cout = w.shape[-1]
    shape = [B, N, idx.shape[-1], cin, cout]
    xr = x.clone().requires_grad_()
    exact = torch.autograd.grad(conv.subm_conv_plain(xr, idx, ok, w), xr,
                                g)[0]
    e_dx = _err(conv.conv_input_grad(g, idx, ok, w), exact,
                "conv dx vs the exact adjoint")
    del xr, exact
    centre = idx.shape[-1] // 2
    owner = idx[..., centre]
    gv = torch.where(ok[..., centre, None], g, torch.zeros_like(g))
    k8 = check_scatter_add(((gv, owner), gv))
    # K2's two launches of this conv in the step, timed on their inputs:
    # the forward, and the mirrored weight on the owner sums (the dx)
    gsum = gather.scatter_rows_add(gv, owner, N)
    wm = conv.mirror_weight(w)
    flops = 2 * cin * cout * int(ok.sum())
    k2 = []
    for what, args, c_out in (("K2", (x, idx, ok, w, bias), cout),
                              ("mirrored K2", (gsum, idx, ok, wm), cin)):
        run = lambda a=args: conv.subm_conv(*a)  # noqa: E731
        plain = lambda a=args: conv.subm_conv_plain(*a)  # noqa: E731
        err = _err(_twice(run, f"{what} {shape}"), plain(),
                   f"{what} {shape}")
        k2.append(dict(_timed_tc(run, plain, None,
                                 _conv_bytes(args[0], idx, args[3], c_out),
                                 flops, *K2_PROFILE),
                       max_abs_err=err, shape=shape,
                       shares=link_shares(ok), pairs=ok.numel()))
    return {"shape": list(x.shape) + [cout], "max_abs_err": e_dx,
            "mirrored_k2_err": k2[1]["max_abs_err"]}, k8, k2


def _index_add(g, idx, n):
    """The library yardstick of a scatter-add that drops sentinel rows:
    one index_add_ into B * (n + 1) rows, each cloud's rows outside [0, n)
    sent to its spare row (the flat index built outside the timed call)."""
    B, _, D = g.shape
    spare = torch.where((idx >= 0) & (idx < n), idx, n).long()
    flat = (spare + torch.arange(B, device=idx.device)[:, None] * (n + 1)
            ).reshape(-1)
    return lambda: torch.zeros(B * (n + 1), D, device=g.device).index_add_(
        0, flat, g.reshape(-1, D))


def check_scatter_add(call):
    """K8 on one captured K4 call (its input and the cotangent of its
    output; the unpools' sentinel rows dropped), or on a conv's owner
    scatter (x stands in for the output shape)."""
    (x, idx), g = call
    B, n, D = x.shape
    run = lambda: gather.scatter_rows_add(g, idx, n)  # noqa: E731
    plain = lambda: gather.scatter_rows_add_plain(g, idx, n)  # noqa: E731
    err = _err(run(), plain(), f"K8 {list(g.shape)} -> {n}")
    nbytes = 4 * (g.numel() + B * n * D) + idx.numel() * idx.element_size()
    return dict(_timed(run, plain, _index_add(g, idx, n), nbytes, g.numel()),
                max_abs_err=err, shape=list(g.shape) + [n],
                sentinel_rows=int(((idx < 0) | (idx >= n)).sum()))


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
    res = {name: [] for name in TRAIN_KERNELS}
    for i, c in enumerate(att):
        r5, r6 = check_attention_train(c, log_sdpa=i == 0)
        res["patch_attention_dropout"].append(r5)
        res["patch_attention_dropout_bwd"].append(r6)
    res["conv_weight_grad"] = [check_weight_grad(c) for c in convs + stems]
    res["scatter_rows_add"] = [check_scatter_add(c) for c in scat]
    log(f"[train-kernels] K8 sentinel rows dropped per K4 backward: "
        f"{[r['sentinel_rows'] for r in res['scatter_rows_add']]}")
    k4 = [dict(check_gather("gather_rows", args, TRAIN_TIMING),
               name="gather_rows") for args, _ in captured["gather_rows"]]
    if len(k4) != PER_STEP["gather_rows"]:
        raise AssertionError(f"captured {len(k4)} K4 calls in a step, "
                             f"expected {PER_STEP['gather_rows']}")
    log_gathers("train-kernels", "K4 per training step", k4)
    k4_row = dict(_row(k4), device_ms=_total(r["device_ms"] for r in k4))
    log(f"[train-kernels] gather_rows: {len(k4)} calls per step, bit-equal, "
        f"{k4_row['ms']:.4f} ms ({k4_row['device_ms']} ms on the device; "
        f"plain {k4_row['plain_ms']:.4f}, bound {k4_row['bound_ms']:.4f}, "
        f"library {k4_row['library_ms']:.4f})")
    conv_dx, k2 = [], []
    for c in convs:
        row, k8, k2_calls = check_conv_dx(c)
        conv_dx.append(row)
        k2 += k2_calls
        res["scatter_rows_add"].append(k8)
    for r in res["conv_weight_grad"]:
        log_conv("train-kernels", "K7 per training step, call", r)
    k2_row = conv_step_row("train-kernels", "K2 per training step", k2)
    rows = {}
    for name, rs in res.items():
        rows[name] = _row(rs)
        for key in ("fp32_bound_ms", "device_ms"):
            if key in rs[0]:
                rows[name][key] = _total(r[key] for r in rs)
        log(f"[train-kernels] {name}: {len(rs)} calls per step, max_abs_err "
            f"{rows[name]['max_abs_err']:.3g}, {rows[name]['ms']:.4f} ms "
            f"(device {rows[name].get('device_ms')}; plain "
            f"{rows[name]['plain_ms']:.4f}, bound "
            f"{rows[name]['bound_ms']:.4f} by {rows[name]['bound_by']}, "
            f"fp32 SIMT bound {rows[name].get('fp32_bound_ms')}, library "
            f"{rows[name]['library_ms']})")
    k5 = res["patch_attention_dropout"]
    log(f"[train-kernels] K5 keep fractions "
        f"{[round(r['keep_fraction'], 5) for r in k5]}; K5 at rate 0 vs K1 "
        f"max err {max(r['rate0_vs_k1_err'] for r in k5):.3g}; lse max err "
        f"{max(r['lse_err'] for r in k5):.3g}; bits bit-equal to "
        f"philox_keep_mask on all {len(k5)} calls")
    log(f"[train-kernels] conv dx (K8 + mirrored K2) vs the exact adjoint: "
        f"max err {max(m['max_abs_err'] for m in conv_dx):.3g}; mirrored K2 "
        f"vs plain {max(m['mirrored_k2_err'] for m in conv_dx):.3g}")
    rows["conv_weight_grad"]["shares"] = _shares(res["conv_weight_grad"])
    return rows, k4_row, k2_row, {"calls": dict(res, gather_rows=k4,
                                                subm_conv=k2),
                                  "conv_dx": conv_dx}


def conv_step_row(tag, label, calls):
    """The row of K2's 9 forward + 9 mirrored dx launches of one training
    step (sums over the calls), logged per call and in total."""
    for i, r in enumerate(calls):
        log_conv(tag, f"{label}, {'forward' if i % 2 == 0 else 'dx'}", r)
    row = dict(_row(calls), launches_per_step=len(calls),
               shares=_shares(calls))
    for key in ("fp32_bound_ms", "device_ms"):
        row[key] = _total(r[key] for r in calls)
    log(f"[{tag}] {label}: {len(calls)} launches, {row['ms']:.4f} ms "
        f"(device {row['device_ms']}; plain {row['plain_ms']:.4f}; bound "
        f"{row['bound_ms']:.4f} TF32, {row['fp32_bound_ms']:.4f} fp32 SIMT)"
        f"; shares {row['shares']}")
    return row


class LeakyReluDecisions:
    """Leaky-ReLU decisions recorded on one device and followed on another,
    around one step (patches F.leaky_relu).

    A leaky ReLU is max(z, s z): its gradient is 1 or s (0.02 in the action
    heads) by the sign of z. Where a pre-activation lies within rounding of
    0, the card and the CPU, which round the layers before it differently
    (~1e-6 relative), can take different branches, and that element's
    gradient then differs by 1 / s: a near tie, like two rows of a max
    reduction within rounding of each other. One such element moves the
    weight gradient of the layer before the kink past GRAD_TOL.

    follow=None: record each call's decisions (z > 0), in call order.
    follow=decisions of another run of the same step: keep this run's
    forward values but take the gradient of the recorded branch where the
    two differ, provided the element is a tie (|z| <= tol of the call's
    max|z|) and at most `limit` elements are followed in all; anything
    else raises. `forced` counts the followed elements, `worst` is their
    largest |z| over their call's max|z|."""

    def __init__(self, follow=None, tol=KINK_TOL, limit=MAX_KINKS):
        self.follow, self.tol, self.limit = follow, tol, limit
        self.decisions, self.forced, self.worst = [], 0, 0.0
        self._leaky = None

    def __enter__(self):
        self._leaky = F.leaky_relu
        F.leaky_relu = self._call
        return self

    def __exit__(self, *exc):
        F.leaky_relu = self._leaky

    def _call(self, z, negative_slope=0.01, inplace=False):
        if inplace:
            raise ValueError("LeakyReluDecisions: in-place leaky ReLU")
        out = self._leaky(z, negative_slope)
        pos = (z > 0).detach()
        i = len(self.decisions)
        self.decisions.append(pos.cpu())
        if self.follow is None:
            return out
        if i >= len(self.follow) or self.follow[i].shape != pos.shape:
            raise ValueError(f"leaky ReLU call {i}: no recorded decisions "
                             f"of shape {tuple(pos.shape)} to follow")
        want = self.follow[i].to(pos.device)
        differ = want != pos
        if not bool(differ.any()):
            return out
        za = z.detach().abs()
        rel = float(za[differ].max()) / max(float(za.max()), 1e-30)
        if rel > self.tol:
            raise ValueError(f"leaky ReLU call {i}: decisions differ at |z| "
                             f"= {rel:.3g} of max|z|, not a tie")
        self.forced += int(differ.sum())
        if self.forced > self.limit:
            raise ValueError(f"leaky ReLU call {i}: {self.forced} decisions "
                             f"followed, more than {self.limit}")
        self.worst = max(self.worst, rel)
        branch = torch.where(want, z, negative_slope * z)
        # the forward value of this run, the gradient of the followed branch
        return out.detach() + (branch - branch.detach())


def _record_max_decisions(model):
    """Forward pre-hooks that record each max reduction's decision: the
    winning row of every (segment, channel) of each grid pooling (lowest row
    on an exact tie) and the winning point of every (cloud, channel) of the
    head's pooled max; and hooks that record when each module first starts
    and first ends. Returns ([(module name, decisions)], {module name:
    [start, end]}, hook handles)."""
    rec, spans, clock = [], {}, iter(range(1 << 62))

    def start_hook(name):
        def hook(mod, args):
            spans.setdefault(name, [next(clock), None])
        return hook

    def end_hook(name):
        def hook(mod, args, out):
            if spans[name][1] is None:
                spans[name][1] = next(clock)
        return hook

    def pool_hook(name):
        def hook(mod, args):
            feat, maps, child_cap = args
            with torch.no_grad():
                v = mod.proj(feat)
                B, N, C = v.shape
                seg = maps.seg_sorted[..., None].expand(B, N, C)
                best = v.new_full((B, child_cap + 1, C), -math.inf)
                best.scatter_reduce_(1, seg, v, reduce="amax")
                rows = torch.arange(N, device=v.device)[None, :, None]
                rows = torch.where(v == best.gather(1, seg), rows, N)
                win = torch.full((B, child_cap + 1, C), N, device=v.device)
                rec.append((name, win.scatter_reduce_(
                    1, seg, rows, reduce="amin").cpu()))
        return hook

    def head_hook(mod, args):
        emb, mask = args[0], args[1]
        with torch.no_grad():
            rec.append(("act_proj_head", torch.where(
                mask[..., None], emb, -math.inf).argmax(1).cpu()))
    handles = []
    for n, m in model.named_modules():
        handles += [m.register_forward_pre_hook(start_hook(n)),
                    m.register_forward_hook(end_hook(n))]
    handles += [m.register_forward_pre_hook(pool_hook("ptv3_model." + n))
                for n, m in model.ptv3_model.named_children()
                if n.endswith("_down")]
    handles.append(model.act_proj_head.register_forward_pre_hook(head_hook))
    return rec, spans, handles


def _one_step(cfg, loss_fn, batch, dev, follow=None):
    """One dropout-0 step with the injected permutations; the losses, the
    gradients, the updated state, the max decisions, the module spans, the
    seconds and the leaky-ReLU decisions (LeakyReluDecisions: recorded, or
    with `follow` the recorded ones followed at ties), on the host."""
    act_cfg = dict(cfg.MODEL.action_config, pos_heatmap_type=cfg.TRAIN_DATASET
                   .get("pos_heatmap_type", "dist"))
    loss_cfg = dict(cfg.MODEL.loss_config)
    model = build_model(cfg.MODEL, device=dev, seed=1)
    opt, _ = build_optimizer(model, dict(cfg.TRAIN))
    trainer = Trainer(model, lambda p, b: loss_fn(p, b, act_cfg, loss_cfg),
                      opt, Randomness(0, dev, perms=CHECK_PERMS))
    decisions, spans, handles = _record_max_decisions(model)
    t0 = time.perf_counter()
    with LeakyReluDecisions(follow) as kinks:
        losses = _losses(trainer.step(batch_to_device(batch, dev)))
    seconds = time.perf_counter() - t0
    for h in handles:
        h.remove()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    state = {n: t.detach().cpu() for n, t in model.state_dict().items()}
    return losses, grads, state, decisions, spans, seconds, kinks


def _module_start(spans, leaf):
    """When the module of parameter `leaf` first started; for a parameter
    read outside its own module's forward (an embedding table read as
    .weight), the start of its nearest ancestor that ran, which is no
    later than the read."""
    name = leaf.rpartition(".")[0]
    while name not in spans:
        name = name.rpartition(".")[0]
    return spans[name][0]


def step_check_phase(host_batch, config=train_config, loss_fn=compute_loss,
                     tag="step-check", slices=CHECK_SLICES):
    """One step at dropout 0 with injected order permutations on each of
    the first `slices` B = 2 slices of the batch, the same seeded weights on
    the card and on the CPU: the losses, every updated parameter and
    running statistic at TOL, and every gradient at GRAD_TOL.

    A gradient below a max reduction (grid pooling, the head's pooled max)
    moves as a whole to another row when two candidates lie within rounding
    of each other and the card and the CPU rank them apart, which is no
    kernel error. So the check counts, per slice and per reduction, the max
    decisions on which the two differ. On a slice where some differ it
    still holds the gradient of every module that first starts after the
    last such reduction has ended (no backward through a differing
    decision reaches it), and reports the worst of the rest. Every gradient
    must be held on at least one slice.

    A leaky ReLU (the action heads) is max(z, 0.02 z): a pre-activation
    within rounding of 0 takes the other branch on the other device and
    moves that element's gradient 50-fold, which moved
    `act_proj_head.heatmap_mlp_fc1.weight` by up to 1.7e-3. The CPU run
    follows the card's leaky-ReLU decisions where they differ and the
    element is a tie (|z| <= KINK_TOL max|z|, at most MAX_KINKS elements;
    LeakyReluDecisions raises otherwise), keeping its own forward
    values."""
    cfg = config("MODEL.ptv3_config.attn_drop", "0.0",
                 "MODEL.ptv3_config.proj_drop", "0.0",
                 "MODEL.action_config.dropout", "0.0")
    rows, held_somewhere = [], set()
    for i in range(slices):
        batch = {k: v[2 * i:2 * i + 2] for k, v in host_batch.items()}
        lc, gc, sc, dc, spans, tc, kc = _one_step(cfg, loss_fn, batch,
                                                  "cuda")
        lr, gr, sr, dr, _, tr, kr = _one_step(cfg, loss_fn, batch, "cpu",
                                              kc.decisions)
        differ = {}
        for (name, a), (_, b) in zip(dc, dr):
            if (a != b).any():
                differ[name] = differ.get(name, 0) + int((a != b).sum())
        row = {"slice": i, "max_decisions": sum(d.numel() for _, d in dr),
               "differing": differ, "kinks_followed": kr.forced,
               "kink_worst": kr.worst, "losses_card": lc, "losses_cpu": lr,
               "loss": max(abs(lc[k] - lr[k]) / max(1.0, abs(lr[k]))
                           for k in lr)}
        if row["loss"] > TOL:
            raise AssertionError(f"slice {i}: card vs CPU losses {lc} vs {lr}")
        row["state"] = 0.0
        for n, t in sr.items():
            if t.is_floating_point():
                e = float((sc[n] - t).abs().max()) / max(
                    1.0, float(t.abs().max()))
                row["state"] = max(row["state"], e)
                if e > TOL:
                    raise AssertionError(f"slice {i}: card vs CPU updated "
                                         f"{n}: {e}")
        gmax = max(float(g.abs().max()) for g in gr.values())
        rel = {n: float((gc[n] - g).abs().max()) /
               max(float(g.abs().max()), 1e-3 * gmax) for n, g in gr.items()}
        last_end = max((spans[name][1] for name in differ), default=-1)
        held = [n for n in gr
                if not differ or _module_start(spans, n) > last_end]
        for n in held:
            if rel[n] > GRAD_TOL:
                raise AssertionError(f"slice {i}: card vs CPU gradient {n}: "
                                     f"{rel[n]} of max(|grad|, 1e-3 "
                                     f"max|grads|)")
        held_somewhere.update(held)
        free = set(gr).difference(held)
        row.update(grads=len(gr), grads_held=len(held),
                   grad_rel=max((rel[n] for n in held), default=0.0),
                   grad_rel_not_held=max(((rel[n], n) for n in free),
                                         default=None))
        rows.append(row)
        rest = ("none" if not free else "{:.3g} ({})".format(
            *row["grad_rel_not_held"]))
        log(f"[{tag}] B=2 (slice {i}), dropout 0, injected permutations: "
            f"{row['max_decisions']} max decisions, differing between card "
            f"and CPU {differ or 'on none'}; leaky-ReLU ties followed "
            f"{kr.forced} (|z| <= {kr.worst:.3g} max|z|); losses card {lc} "
            f"vs CPU {lr}; "
            f"worst relative errors: loss {row['loss']:.3g}, state "
            f"{row['state']:.3g}, {len(held)} of {len(gr)} gradients held "
            f"{row['grad_rel']:.3g}, the rest {rest} (card {tc:.2f} s, "
            f"CPU {tr:.2f} s per step)")
    missing = sorted(set(gr) - held_somewhere)
    if missing:
        raise AssertionError(f"{len(missing)} gradients held on no slice of "
                             f"{slices}, e.g. {missing[:5]}")
    return {"slices": rows, "loss": max(r["loss"] for r in rows),
            "state": max(r["state"] for r in rows),
            "grad_rel": max(r["grad_rel"] for r in rows)}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def entry_phase(module=train_simple_policy, config=train_config,
                steps=ENTRY_STEPS, per_step=PER_STEP, tag="entry"):
    """module.main (train_simple_policy or train_motion_planner) on the
    card as a user starts it: `steps` steps of run_training, each host
    batch made in series with the steps, a log line after step steps / 2
    and after the last (each reads the losses, a sync). Launch counters
    read against per_step; the end-to-end rate is the clouds of the second
    half over the time between the two lines."""
    half = steps // 2
    cfg = config("TRAIN.num_train_steps", str(steps),
                 "TRAIN.log_steps", str(half))
    logger = logging.getLogger("robot3dlotus_tpu_torch.train")
    handler, level = _Records(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    try:
        trainer = module.main(cfg)
        torch.cuda.synchronize()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    total_s = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    if trainer.optimizer.count != steps:
        raise AssertionError(f"entry point ran {trainer.optimizer.count} "
                             f"steps, expected {steps}")
    del trainer
    for k, per in per_step.items():
        if launches[k] != per * steps:
            raise AssertionError(f"{k}: {launches[k]} launches in "
                                 f"{steps} entry-point steps, expected "
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
    out = {"steps": steps, "wall_s": total_s,
           "second_half_s": span_s,
           "clouds_per_s": clouds / span_s,
           "step_ms": span_s * 1e3 / half,
           "launches": launches,
           "log": [r.getMessage() for r in lines]}
    log(f"[{tag}] {module.__name__.rsplit('.', 1)[-1]}.main, {steps} steps "
        f"in {total_s:.2f} s (build included); steps {half + 1}-{steps} "
        f"{out['step_ms']:.1f} ms each with their host batches, "
        f"{out['clouds_per_s']:.2f} clouds/s end to end")
    for m in out["log"]:
        log(f"[{tag}]   {m}")
    return out



# ------------------------------------------------------- motion planner ---

def mp_config(*opts):
    return get_config(MP_CONFIG, MP_TRAIN_OPTS + list(opts))


def mp_pipeline(engine):
    """The GT pipeline of robot_pipeline_gt.yaml around `engine`."""
    with open(GT_CONFIG) as f:
        return GroundtruthRobotPipeline(yaml.safe_load(f),
                                        motion_planner=engine)


def mp_episode(pipe, observations, seed):
    """One episode of the GT taskvar over `observations` (the vision's
    sampling seeded); returns the actions and each request's seconds."""
    pipe.vision.rng = np.random.RandomState(seed)
    task, var = TASKVAR.split("+")
    cache, actions, lat = None, [], []
    for i, o in enumerate(observations):
        t0 = time.perf_counter()
        out = pipe.predict(task_str=task, variation=int(var), step_id=i,
                           obs_state_dict=o, episode_id=0, cache=cache)
        lat.append(time.perf_counter() - t0)
        cache = out["cache"]
        actions.append(out["action"])
    return actions, lat


def mp_inputs(pipe, obs):
    """The motion planner's host inputs for one observation: GT vision
    (labels, normalised cloud) and the plan's action-name embedding."""
    plan = parse_code(pipe.llm_planner(TASKVAR)[0])
    inp = pipe.vision(TASKVAR, 0, obs["pc"], obs["gt_mask"], obs["gripper"],
                      obs["arm_links_info"])
    return inp, pipe.text_embedder(_plan_action_name(plan))


def mp_serving_phase(pipe, observations, out_dir):
    """4 counted pipeline requests, then host prep vs device forward per
    request and a profiler window over 3 forwards."""
    mp_episode(pipe, observations[:1], 7)                 # warm-up
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    actions, lat = mp_episode(pipe, observations, 1)
    launches = dict(cuda_lib.LAUNCHES)
    for k, per in MP_PER_FORWARD.items():
        if launches[k] != per * len(observations):
            raise AssertionError(f"{k}: {launches[k]} launches in "
                                 f"{len(observations)} pipeline requests, "
                                 f"expected {per} per forward")
    for i, a in enumerate(actions):
        if a.shape != (8,) or not np.isfinite(a).all():
            raise AssertionError(f"pipeline request {i}: bad action {a}")
    engine = pipe.motion_planner
    pipe.vision.rng = np.random.RandomState(1)
    prep_ms, fwd_ms, rows = [], [], []
    for o in observations:
        t0 = time.perf_counter()
        inp, txt = mp_inputs(pipe, o)
        t1 = time.perf_counter()
        traj = engine.predict(inp["pc_fts"], inp["pc_labels"], txt,
                              inp["ee_poses"], inp["pc_centroids"],
                              inp["pc_radius"], pipe.vision.TABLE_HEIGHT)
        t2 = time.perf_counter()
        if traj.shape != (5, 9) or not np.isfinite(traj).all():
            raise AssertionError(f"bad trajectory {traj}")
        prep_ms.append((t1 - t0) * 1e3)
        fwd_ms.append((t2 - t1) * 1e3)
        rows.append((inp, txt))
    from torch.profiler import ProfilerActivity, profile
    batches = [engine._batch(i["pc_fts"], i["pc_labels"], t)
               for i, t in rows[:3]]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            engine.forward(b)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    with open(os.path.join(out_dir, "profile_mp_forward.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    ops = _device_ops(events, len(batches))
    busy = sum(o[1] for o in ops)
    fwd_p50 = float(np.median(fwd_ms))
    out = {"request_ms": [t * 1e3 for t in lat],
           "request_p50_ms": float(np.median(lat)) * 1e3,
           "host_prep_ms": prep_ms, "host_prep_ms_p50":
           float(np.median(prep_ms)), "predict_ms": fwd_ms,
           "predict_ms_p50": fwd_p50,
           "points": [len(i["pc_fts"]) for i, _ in rows],
           "labels": [np.bincount(i["pc_labels"], minlength=4).tolist()
                      for i, _ in rows],
           "profiled_forward_wall_ms": wall_ms / len(batches),
           "device_busy_ms_per_forward": busy,
           "device_launches_per_forward": _device_launches(events,
                                                           len(batches)),
           "device_idle_share": 1.0 - busy / fwd_p50,
           "device_ms_by_group": _group_device_ops(ops),
           "launches": launches, "actions": [a.tolist() for a in actions]}
    log(f"[mp-serving] {len(observations)} GT pipeline requests: p50 "
        f"{out['request_p50_ms']:.2f} ms (all "
        f"{[round(t, 2) for t in out['request_ms']]}); points "
        f"{out['points']}, labels per class {out['labels']}; launches "
        f"{launches}")
    log(f"[mp-serving] MotionPlannerEngine.predict p50 {fwd_p50:.2f} ms "
        f"(all {[round(t, 2) for t in fwd_ms]}); host prep (GT vision, "
        f"labels, text) p50 {out['host_prep_ms_p50']:.2f} ms; device busy "
        f"{busy:.2f} ms per forward in "
        f"{out['device_launches_per_forward']:.2f} device launches (profiled "
        f"wall {out['profiled_forward_wall_ms']:.2f} ms), idle share "
        f"{out['device_idle_share']:.3f}")
    for g, v in out["device_ms_by_group"].items():
        log(f"[mp-serving]   {v['ms']:.4f} ms x{v['count']}  {g}")
    return out, rows[0]


def mp_reference_phase(engine, row):
    """The card's trajectory logits for one observation against the same
    weights on the CPU; the decoded trajectory finite."""
    inp, txt = row
    batch = engine._batch(inp["pc_fts"], inp["pc_labels"], txt)
    cpu_model = build_model(engine.config.MODEL, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               engine.model.state_dict().items()})
    with torch.inference_mode():
        gpu = engine.model(batch)
        cpu = cpu_model({k: v.cpu() for k, v in batch.items()})
        traj = decode_mp_actions(gpu, engine.act_cfg).cpu()
    errs = {}
    for k in ("pos", "rot", "open", "stop"):
        ref = cpu[k]
        errs[k] = float((gpu[k].cpu() - ref).abs().max())
        live = ref[ref > -1e8]     # masked candidates hold -1e9 on both
        lim = 1e-3 * max(1.0, float(live.abs().max()))
        if errs[k] > lim:
            raise AssertionError(f"motion planner {k}: card vs CPU max "
                                 f"|diff| {errs[k]} > {lim}")
    if traj.shape != (1, 5, 9) or not bool(torch.isfinite(traj).all()):
        raise AssertionError(f"decoded trajectory {traj}")
    errs["pool_overflow"] = int(gpu["pool_overflow"])
    log(f"[mp-serving] card vs CPU trajectory logits, max |diff|: {errs}")
    return errs


def check_smallc_bwd(idx, n, C, seed, timing):
    """K10 on a captured index with a seeded cotangent of C channels:
    within 1e-4 * max|plain| (atomics); times against the plain version
    and one index_add_ whose sentinel rows land in a spare row per
    cloud."""
    B, M = idx.shape
    gen = torch.Generator(device=idx.device).manual_seed(seed)
    g = torch.randn(B, M, C, generator=gen, device=idx.device)
    run = lambda: gather.scatter_rows_smallc_add(g, idx, n)  # noqa: E731
    plain = lambda: gather.scatter_rows_smallc_add_plain(  # noqa: E731
        g, idx, n)
    err = _err(run(), plain(), f"K10 {[B, M, C]} -> {n}")
    bound_ms, t_b, t_f = _bound(4 * (g.numel() + B * n * C) +
                                idx.numel() * idx.element_size(), g.numel())
    return {"shape": [B, M, C, n], "max_abs_err": err,
            "ms": cuda_ms(run, **timing), "plain_ms": cuda_ms(plain, **timing),
            "library_ms": cuda_ms(_index_add(g, idx, n), **timing),
            "bound_ms": bound_ms, "bytes_s": t_b, "flops_s": t_f}


def _row(results):
    lib = [r["library_ms"] for r in results]
    return {"max_abs_err": max(r["max_abs_err"] for r in results),
            "ms": sum(r["ms"] for r in results),
            "plain_ms": sum(r["plain_ms"] for r in results),
            "bound_ms": sum(r["bound_ms"] for r in results),
            "bound_by": "bytes" if sum(r["bytes_s"] for r in results) >=
            sum(r["flops_s"] for r in results) else "operations",
            "library_ms": None if None in lib else sum(lib)}


def mp_kernel_phase(captured_fwd, captured_step):
    """K9 on every captured call of one forward (B = 1) and of one training
    step (B = 32), K10 on both stem indices at C = 5 and C = 20. Rows:
    K9 per forward (its per-step sums under "train_step"), K10 per
    training-step shape at C = 5 (it launches 0 times per step: the stem
    gathers data)."""
    rows, detail = {}, {}
    for name, cap, timing in (("forward", captured_fwd, {}),
                              ("step", captured_step, TRAIN_TIMING)):
        calls = [args for args, _ in cap["gather_rows_smallc"]]
        if sorted(a[0].shape[-1] for a in calls) != [4, 5]:
            raise AssertionError(f"K9 calls per {name}: "
                                 f"{[list(a[0].shape) for a in calls]}")
        k9 = [check_gather("gather_rows_smallc", a, timing) for a in calls]
        stem_x, stem_idx = next(a for a in calls if a[0].shape[-1] == 5)
        k10 = [check_smallc_bwd(stem_idx, stem_x.shape[1], C, 11 + C, timing)
               for C in (5, 20)]
        detail[name] = {"gather_rows_smallc": k9,
                        "scatter_rows_smallc_add": k10}
        log_gathers("mp-kernels", f"K9 per {name}", k9)
        for r in k10:
            log(f"[mp-kernels] K10 per {name}: {r['shape']} max_abs_err "
                f"{r['max_abs_err']:.3g}, {r['ms']:.4f} ms (plain "
                f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
                f"{r['bound_ms']:.4f})")
        k9_row = dict(_row(k9), device_ms=_total(r["device_ms"] for r in k9))
        if name == "forward":
            rows["gather_rows_smallc"] = k9_row
        else:
            rows["gather_rows_smallc"]["train_step"] = k9_row
            rows["scatter_rows_smallc_add"] = _row(k10[:1])
    return rows, detail


def mp_forward_k2(calls):
    """K2 on the captured calls of one pipeline request (B = 1), each
    checked as check_conv does; run right after the capture, so that the
    copies are freed before the training phases measure peak memory."""
    if len(calls) != MP_PER_FORWARD["subm_conv"]:
        raise AssertionError(f"captured {len(calls)} K2 calls in a pipeline "
                             "request")
    res = [check_conv(args, timed=False) for args, _ in calls]
    for r in res:
        log_conv("mp-kernels", "K2 per pipeline request, call", r)
    return res


def mp_conv_phase(captured):
    """K2 (9 forward + 9 mirrored dx launches) and K7 (the 9 CPE convs) on
    the calls of one captured motion-planner training step at B = 32,
    checked and timed as the policy's (check_conv_dx, check_weight_grad);
    returns the K2 and K7 rows per step and the detail."""
    convs = [c for c in captured["subm_conv"] if c[1] is not None]
    if len(convs) != 9:
        raise AssertionError(f"captured {len(convs)} motion-planner conv "
                             "calls with a cotangent, expected 9")
    k2, k7, dx = [], [], []
    for c in convs:
        row, _, calls = check_conv_dx(c)
        dx.append(row)
        k2 += calls
        k7.append(check_weight_grad(c))
    k2_row = conv_step_row("mp-kernels", "K2 per MP training step", k2)
    for r in k7:
        log_conv("mp-kernels", "K7 per MP training step, call", r)
    k7_row = dict(_row(k7), shares=_shares(k7), launches_per_step=len(k7))
    for key in ("fp32_bound_ms", "device_ms"):
        k7_row[key] = _total(r[key] for r in k7)
    log(f"[mp-kernels] K7 per MP training step: {k7_row['ms']:.4f} ms "
        f"(device {k7_row['device_ms']}; plain {k7_row['plain_ms']:.4f}; "
        f"bound {k7_row['bound_ms']:.4f} TF32, {k7_row['fp32_bound_ms']:.4f} "
        f"fp32 SIMT); conv dx vs the exact adjoint: max err "
        f"{max(m['max_abs_err'] for m in dx):.3g}")
    return k2_row, k7_row, {"subm_conv": k2, "conv_weight_grad": k7,
                            "conv_dx": dx}


def mp_training(out_dir):
    """The motion planner's trainer on synthetic_motion (B = 32 x 4096,
    release dropout): one captured step (K9 inputs at B = 32), 5 counted
    steps and a profiler window, then one more captured step (the convs'
    inputs and cotangents: captured after the counted steps, so that
    their copies stay out of the peak memory); returns the phase, its
    launches, the captures and a host batch for the step check."""
    t0 = time.perf_counter()
    trainer, batches, _ = build_trainer(mp_config(), train_motion_planner.SPEC,
                                        device="cuda")
    host, data_ms = host_batches(batches, 1 + TRAIN_STEPS + PROFILE_STEPS)
    log(f"[mp-train] trainer built and {len(host)} host batches of "
        f"{trainer_batch(host)} clouds made in "
        f"{time.perf_counter() - t0:.1f} s (host ms per batch: "
        f"{[round(t) for t in data_ms]})")
    captured = capture(lambda: trainer.step(batch_to_device(host[0], "cuda")),
                       SMALLC_SITES)
    training, launches = training_phase(trainer, host[1:], out_dir,
                                        MP_PER_STEP, "profile_mp_train.txt",
                                        "mp-train")
    training["host_batch_ms"] = data_ms
    captured.update(capture(
        lambda: trainer.step(batch_to_device(host[0], "cuda")),
        MP_CONV_SITES))
    del trainer
    return training, launches, captured, host[0]


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
    train_rows, k4_step, k2_step, train_detail = train_kernel_phase(
        captured)
    rows["gather_rows"]["train_step"] = k4_step
    rows["subm_conv"]["train_step"] = k2_step
    del captured
    step_check = step_check_phase(host[0])
    entry = entry_phase()
    del host, batches
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    engine = MotionPlannerEngine(MP_CONFIG, device="cuda", seed=0)
    pipe = mp_pipeline(engine)
    log(f"[mp-capture] release-width motion planner and GT pipeline built "
        f"in {time.perf_counter() - t0:.2f} s")
    mp_obs = [synthetic_observation(200 + i) for i in range(MP_REQUESTS)]
    mp_fwd_captured = capture(lambda: mp_episode(pipe, mp_obs[:1], 0),
                              SMALLC_SITES + MP_CONV_SITES)
    mp_fwd_k2 = mp_forward_k2(mp_fwd_captured.pop("subm_conv"))
    mp_serving, mp_row = mp_serving_phase(pipe, mp_obs, out_dir)
    mp_serving["reference_max_diff"] = mp_reference_phase(engine, mp_row)
    del engine, pipe
    torch.cuda.empty_cache()
    mp_train, mp_train_launches, mp_step_captured, mp_host = \
        mp_training(out_dir)
    mp_rows, mp_detail = mp_kernel_phase(mp_fwd_captured, mp_step_captured)
    mp_k2, mp_k7, mp_detail["conv_step"] = mp_conv_phase(mp_step_captured)
    mp_detail["conv_forward"] = mp_fwd_k2
    del mp_fwd_captured, mp_step_captured
    torch.cuda.empty_cache()
    mp_step_check = step_check_phase(mp_host, mp_config, compute_mp_loss,
                                     "mp-step-check", MP_CHECK_SLICES)
    mp_entry = entry_phase(train_motion_planner, mp_config, MP_ENTRY_STEPS,
                           MP_PER_STEP, "mp-entry")

    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "kernels": rows, "calls": detail,
                   "serving": serving, "breakdown": breakdown,
                   "reference_max_diff": ref, "training": training,
                   "train_kernels": train_rows,
                   "train_calls": train_detail, "step_check": step_check,
                   "entry": entry, "mp_serving": mp_serving,
                   "mp_training": mp_train, "mp_kernels": mp_rows,
                   "mp_calls": mp_detail, "mp_step_check": mp_step_check,
                   "mp_entry": mp_entry},
                  f, indent=1)
    # each kernel's launches in the run of its own slice's main path: K1-K4
    # policy serving, K5-K8 policy training, K9 motion-planner serving, K10
    # motion-planner training (0: the stem gathers data); launches_by_path
    # has every run's count for every kernel
    rows.update(train_rows)
    rows.update(mp_rows)
    rows["subm_conv"]["mp_train_step"] = mp_k2
    rows["conv_weight_grad"]["mp_train_step"] = mp_k7
    paths = {"serving": serving["launches"], "training": train_launches,
             "mp_serving": mp_serving["launches"],
             "mp_training": mp_train_launches}
    main_path = dict.fromkeys(PER_FORWARD, "serving")
    main_path.update(dict.fromkeys(TRAIN_KERNELS, "training"))
    main_path.update(gather_rows_smallc="mp_serving",
                     scatter_rows_smallc_add="mp_training")
    kernels = [dict(name=k, route="cuda", source=KERNELS[k][0],
                    replaces=KERNELS[k][1],
                    launches=paths[main_path[k]][k],
                    launches_by_path={p: c[k] for p, c in paths.items()},
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
