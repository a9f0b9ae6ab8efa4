#!/usr/bin/env python3
"""Compare two trees of the PyTorch port on one card, in turns.

    python3 scripts/torch_parent_ab.py PARENT_ROOT CHANGE_ROOT [--order pccp]
    python3 scripts/torch_parent_ab.py PARENT_ROOT CHANGE_ROOT \
        --step-check 6 --order pca

Each root is a checkout of the repo (e.g. `git archive` of a commit
unpacked into a git-ignored directory). Each turn of --order (p: the
first root, c: the second; q: the first with the policy trainer's SEED 7,
n: the second with per-step reseeding, `Randomness.at_step`, off: turns
that vary the random draws, on which the step time depends) is a fresh
Python process with that root first on sys.path; it imports that tree's
chip_smoke.py and runs its phases:
policy serving (`serving_phase`, `breakdown_phase`: predict p50, device
forward p50, device launches per forward), policy training
(`training_phase`: 5 counted steps and a profiler window over 2 more at
B = 32 x 4096), motion-planner serving (`mp_serving_phase`) and training
(`mp_training`); where the tree has `Randomness.at_step`, the host µs of
one call, over 1000. Each tree checks its own launch counts. One JSON line per
turn is printed and all of them are written to
chiprun_out/parent_ab.json. Needs one CUDA card.

With --step-check N a turn runs instead the policy's card-vs-CPU training
step (chip_smoke's `_one_step`: dropout 0, injected permutations, seeded
weights) on each of the first N B = 2 slices of the trainer's first host
batch and reports, per slice, the max decisions that differ between the
devices and the five gradients furthest apart (|card - CPU| over
max(|grad|, 1e-3 max|grads|), chip_smoke's measure), holding nothing.
Order letter `a` is the change tree with the training attention's CUDA
kernels (K5, K6) swapped for their plain versions on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

TURN = r"""
import json, os, sys, time
import numpy as np
import torch
root, variant = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
os.chdir(root)
import chip_smoke as cs
if variant == "n":
    cs.layers.Randomness.at_step = lambda self, step: None
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out_dir = os.path.join(root, "chiprun_out")
os.makedirs(out_dir, exist_ok=True)
res = {}
actioner = cs.Actioner(cs.CONFIG, cli_opts=cs.CLI_OPTS, device="cuda",
                       seed=0)
obs = [cs.synthetic_observation(100 + i) for i in range(4)]
actioner.rng = np.random.default_rng(0)
res["serving"] = cs.serving_phase(actioner, obs)
res["breakdown"] = cs.breakdown_phase(actioner, obs, out_dir)
del actioner
seed = ["SEED", "7"] if variant == "q" else []
trainer, batches, _ = cs.build_trainer(cs.train_config(*seed), cs.SPEC,
                                       device="cuda")
host, _ = cs.host_batches(batches, 1 + cs.TRAIN_STEPS + cs.PROFILE_STEPS)
res["training"] = cs.training_phase(trainer, host[1:], out_dir)[0]
at_step_us = None
if variant == "c" and hasattr(trainer.rng, "at_step"):
    t0 = time.perf_counter()
    for i in range(1000):
        trainer.rng.at_step(i)
    at_step_us = (time.perf_counter() - t0) * 1e3
del trainer, batches, host
torch.cuda.empty_cache()
engine = cs.MotionPlannerEngine(cs.MP_CONFIG, device="cuda", seed=0)
pipe = cs.mp_pipeline(engine)
mp_obs = [cs.synthetic_observation(200 + i) for i in range(cs.MP_REQUESTS)]
res["mp_serving"] = cs.mp_serving_phase(pipe, mp_obs, out_dir)[0]
del engine, pipe
torch.cuda.empty_cache()
res["mp_training"] = cs.mp_training(out_dir)[0]
keep = {"serving": ("predict_p50_ms", "predict_batch4_ms"),
        "breakdown": ("host_prep_ms_p50", "forward_ms_p50",
                      "device_busy_ms_per_forward",
                      "device_launches_per_forward"),
        "training": ("step_ms_p50", "step_ms", "peak_mem_gib",
                     "device_busy_ms_per_step", "device_ms_by_group"),
        "mp_serving": ("request_p50_ms", "host_prep_ms_p50",
                       "predict_ms_p50", "device_busy_ms_per_forward",
                       "device_launches_per_forward"),
        "mp_training": ("step_ms_p50", "step_ms", "peak_mem_gib",
                        "device_busy_ms_per_step", "device_ms_by_group")}
summary = {k: {f: v[f] for f in keep[k]} for k, v in res.items()}
summary["training"]["at_step_us"] = at_step_us
print("AB " + json.dumps(summary, default=str), flush=True)
"""

STEP_CHECK = r"""
import json, os, sys
import torch
root, slices, plain = sys.argv[1], int(sys.argv[2]), sys.argv[3] == "1"
sys.path.insert(0, root)
os.chdir(root)
import chip_smoke as cs
from robot3dlotus_tpu_torch.ops import attention
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
if plain:
    attention.patch_attention_dropout_fwd = \
        attention.patch_attention_dropout_fwd_plain
    attention.patch_attention_dropout_bwd = \
        attention.patch_attention_dropout_bwd_plain
trainer, batches, _ = cs.build_trainer(cs.train_config(), cs.SPEC,
                                       device="cuda")
host = next(batches)
del trainer, batches
cfg = cs.train_config("MODEL.ptv3_config.attn_drop", "0.0",
                      "MODEL.ptv3_config.proj_drop", "0.0",
                      "MODEL.action_config.dropout", "0.0")
rows = []
for i in range(slices):
    batch = {k: v[2 * i:2 * i + 2] for k, v in host.items()}
    card = cs._one_step(cfg, cs.compute_loss, batch, "cuda")
    cpu = cs._one_step(cfg, cs.compute_loss, batch, "cpu")
    gc, dc, gr, dr = card[1], card[3], cpu[1], cpu[3]
    differ = {n: int((a != b).sum()) for (n, a), (_, b) in zip(dc, dr)
              if (a != b).any()}
    gmax = max(float(g.abs().max()) for g in gr.values())
    rel = {n: float((gc[n] - g).abs().max()) /
           max(float(g.abs().max()), 1e-3 * gmax) for n, g in gr.items()}
    rows.append({"slice": i, "differing": differ,
                 "worst": sorted(rel.items(), key=lambda t: -t[1])[:5]})
    print(json.dumps(rows[-1]), flush=True)
print("AB " + json.dumps({"step_check": rows}), flush=True)
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--order", default="pccp")
    ap.add_argument("--step-check", type=int, default=0)
    args = ap.parse_args()
    roots = {"p": os.path.abspath(args.parent),
             "q": os.path.abspath(args.parent),
             "c": os.path.abspath(args.change),
             "n": os.path.abspath(args.change),
             "a": os.path.abspath(args.change)}
    turns = []
    for i, who in enumerate(args.order):
        cmd = [sys.executable, "-c", TURN, roots[who], who]
        if args.step_check:
            cmd = [sys.executable, "-c", STEP_CHECK, roots[who],
                   str(args.step_check), "1" if who == "a" else "0"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"turn {i} ({who}) failed: rc "
                             f"{proc.returncode}")
        turn = dict(json.loads(lines[-1][3:]), turn=i,
                    tree={"p": "parent", "c": "change",
                          "q": "parent, SEED 7",
                          "n": "change, no per-step reseeding",
                          "a": "change, plain attention"}[who])
        turns.append(turn)
        print(json.dumps(turn), flush=True)
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "parent_ab.json"), "w") as f:
        json.dump(turns, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
