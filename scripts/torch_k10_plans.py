#!/usr/bin/env python3
"""Device time of K10 (the small-C scatter-add) under each block plan, on
the stem input gradient of one training step, on one card.

    python3 scripts/torch_k10_plans.py
    python3 scripts/torch_k10_plans.py --tree ROOT    # one tree's K10, seeded

Captures the stem call of one policy training step (B = 32 clouds x 4096
points, chip_smoke.py's trainer) and builds K10's operands of its input
gradient (`stem.stem_grad_rows`: G = g W^T, C = 7, and the map with dead
links at the sentinel row). Then, through the forced-plan entry point
(`gather.scatter_rows_smallc_add_split`), times on the profiler (device
time per call of both K10 kernels, 10 calls in one window) K10 at C = 7
and, on the same index with seeded cotangents, at C = 5 and C = 20, with
ranges 1, 2, 4, 8 and 16 a cloud and the wrapper's own plan
(scatter_smallc_plan); each beside its bytes bound (g, the index and dx
moved once, at 3.35 TB/s). Prints the card's name and power limit and one
JSON line per measurement, and writes chiprun_out/k10_plans.json. Needs
one CUDA card.

With --tree ROOT (a checkout of the repo, e.g. a parent commit unpacked
from `git archive`) it times instead that tree's
`gather.scatter_rows_smallc_add`, whatever its design, on seeded operands
(B = 32 clouds, n = 4096 rows, M = 125 n links a cloud, 83% of them at
the sentinel n, the others within 300 rows of their own row, as a
serialized stem map's are; C = 5, 7 and 20): device time on the profiler
(every kernel whose name holds "scatter_smallc") and by events, so that
two trees compare in one call, in turns (parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANGES = (1, 2, 4, 8, 16)


def seeded_tree(root, smi):
    """K10 of the tree at `root` on seeded stem-like operands."""
    sys.path.insert(0, os.path.abspath(root))
    from robot3dlotus_tpu_torch.ops import gather
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, n, K = 32, 4096, 125
    off = torch.randint(-300, 301, (B, n, K), generator=gen, device="cuda")
    idx = (torch.arange(n, device="cuda")[None, :, None] + off).clamp(
        0, n - 1)
    idx[torch.rand(B, n, K, generator=gen, device="cuda") < 0.83] = n
    idx = idx.reshape(B, n * K).int().contiguous()
    rows = []
    for C in (5, 7, 20):
        g = torch.randn(B, n * K, C, generator=gen, device="cuda")
        run = lambda: gather.scatter_rows_smallc_add(g, idx, n)  # noqa
        want = gather.scatter_rows_smallc_add_plain(g, idx, n)
        err = float((run() - want).abs().max())
        if err > 1e-4 * float(want.abs().max()):
            raise AssertionError(f"K10 C = {C}: max err {err}")
        for _ in range(3):
            run()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            run()
        end.record()
        end.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                run()
            torch.cuda.synchronize()
        dev = sum(e.device_time_total for e in prof.key_averages()
                  if "scatter_smallc" in e.key) / 10 / 1e3
        bound_ms = (4 * (g.numel() + B * n * C) + 4 * idx.numel()) / \
            3.35e12 * 1e3
        row = {"tree": root, "kernel": "K10", "shape": [B, n * K, C, n],
               "max_abs_err": err, "ms": start.elapsed_time(end) / 10,
               "device_ms": dev, "bound_ms": bound_ms,
               "bound_share": bound_ms / dev if dev else None}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del g, want
    out = os.path.join(ROOT, "chiprun_out", "k10_trees.jsonl")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "a") as f:
        for row in rows:
            f.write(json.dumps(dict(row, device=smi)) + "\n")
    return 0


def device_us(cs, fn, reps=10):
    """Device microseconds per call of fn: K10's main kernel and its
    ranges' sum apart (chip_smoke `cs`'s profiler helpers)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = cs._device_events(prof.key_averages())
    main, extra = cs.K10_PROFILE
    return {n: sum(cs._dev_us(e) for e in cs._named(events, n)) / reps
            for n in (main,) + extra}


def plans(smi):
    """K10 under each plan on one training step's stem input gradient."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from robot3dlotus_tpu_torch.ops import gather, stem
    trainer, batches, _ = cs.build_trainer(cs.train_config(), cs.SPEC,
                                           device="cuda")
    host = next(batches)
    step = cs.capture(lambda: trainer.step(cs.batch_to_device(host, "cuda")),
                      [(cs.sparse_conv, "stem_conv", "stem_conv")])
    del trainer, batches
    (x, idx, ok, w), g = step["stem_conv"][0]
    n = x.shape[1]
    G, flat = stem.stem_grad_rows(g, idx, ok, w, n)
    del step, x, ok, g
    rows = []
    for C in (5, 7, 20):
        gc = G if C == 7 else cs._seeded(flat.shape + (C,), 11 + C)
        B, M, _ = gc.shape
        bound_ms = cs._bound(4 * (gc.numel() + B * n * C) +
                             4 * flat.numel(), gc.numel())[0]
        own = gather.scatter_smallc_plan(B, M, n, C)
        for plan in [(r, own[1]) for r in RANGES] + [own]:
            t = device_us(cs, lambda: gather.scatter_rows_smallc_add_split(
                gc, flat, n, *plan))
            dev_ms = sum(t.values()) / 1e3
            row = {"kernel": "K10", "shape": [B, M, C, n],
                   "plan": list(plan), "wrapper": plan == own,
                   "main_us": t[cs.K10_PROFILE[0]],
                   "sum_us": t[cs.K10_PROFILE[1][0]], "device_ms": dev_ms,
                   "bound_ms": bound_ms, "bound_share": bound_ms / dev_ms}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del gc
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k10_plans.json"), "w") as f:
        json.dump({"device": smi, "rows": rows}, f, indent=1)
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", help="time this tree's K10 on seeded operands")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return seeded_tree(args.tree, smi) if args.tree else plans(smi)


if __name__ == "__main__":
    sys.exit(main())
