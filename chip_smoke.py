#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card (an H100).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):
  1. build   the four hand-written kernels from robot3dlotus_tpu_torch/csrc
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
             weights on the CPU (the plain path).
It prints the kernels line, the card's name and power limit, and as its
last line {"ok": true, "device": {...}}. It needs one CUDA card and exits
non-zero without one.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from robot3dlotus_tpu_torch.eval.actioner import Actioner
from robot3dlotus_tpu_torch.eval.synthetic_obs import synthetic_observation
from robot3dlotus_tpu_torch.models import layers, ptv3
from robot3dlotus_tpu_torch.ops import (attention, conv, cuda_lib, gather,
                                        pooling, sparse_conv, stem)

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
}


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, rounds=21, reps=10, warmup=3):
    """Median over `rounds` of the mean time of `reps` back-to-back calls
    between two CUDA events. A call shorter than its host-side launch cost
    measures that cost: it is what the caller pays."""
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
    the inputs of each call."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args):
        self.calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                                for a in args))
        return self.fn(*args)


def capture_main_path(run):
    """Calls `run` with recorders on every kernel call site; returns the
    recorded inputs by kernel."""
    sites = [(layers, "patch_attention", "patch_attention"),
             (sparse_conv, "subm_conv", "subm_conv"),
             (sparse_conv, "stem_conv", "stem_conv"),
             (pooling, "gather_rows", "gather_rows"),
             (ptv3, "gather_rows", "gather_rows")]
    recs = {k: [] for k in PER_FORWARD}
    saved = []
    for mod, attr, kernel in sites:
        rec = Recorder(getattr(mod, attr))
        saved.append((mod, attr, rec.fn))
        setattr(mod, attr, rec)
        recs[kernel].append(rec)
    try:
        run()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return {k: [c for r in v for c in r.calls] for k, v in recs.items()}


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

    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "kernels": rows, "calls": detail,
                   "serving": serving, "breakdown": breakdown,
                   "reference_max_diff": ref}, f, indent=1)
    kernels = [dict(name=k, route="cuda", source=KERNELS[k][0],
                    replaces=KERNELS[k][1],
                    launches=serving["launches"][k], **rows[k])
               for k in PER_FORWARD]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
