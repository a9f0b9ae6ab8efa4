#!/usr/bin/env python3
"""Device time of K1 (patch attention) and K3 (the stem conv) under each
block plan, on the calls the release model makes, on one card.

    python3 scripts/torch_k1_k3_plans.py

Captures the kernels' inputs from one `Actioner.predict` (B = 1) and one
`predict_batch` of 4 at the release width (chip_smoke.py's serving
capture), and K3's from one training step (B = 32 clouds x 4096 points).
Then, through the wrappers' forced-plan entry points
(`attention.patch_attention_split`, `stem.stem_conv_split`), times on the
profiler (device time per call, 20 calls in one window):
- K1 per B = 1 forward (its 9 calls) with every block size (1, 2, 4, 8
  warps, each patch's query rows split over the matching number of
  blocks), and with the wrapper's own plan (attention_query_split), back
  to back and each call after a 4096 x 4096 fp32 matmul (64 MB written:
  the L2 and the instruction caches cold, as after the forward's other
  kernels);
- K3 at B = 1, B = 4 and B = 32 under several (cols, warps, splits,
  blocks) plans and the wrapper's own (stem_conv_plan), the main kernel
  and the tap-range sum apart.
Prints the card's name and power limit and one JSON line per measurement,
and writes chiprun_out/k1_k3_plans.json. Needs one CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from robot3dlotus_tpu_torch.ops import attention, stem  # noqa: E402

K3_PLANS = {1: [(64, 4, 5, 64), (64, 8, 8, 32), (64, 16, 4, 16),
                (64, 16, 16, 16), (64, 4, 16, 64)],
            4: [(64, 4, 2, 256), (64, 8, 2, 128), (64, 16, 1, 64)],
            32: [(64, 8, 1, 132), (64, 16, 1, 264), (64, 16, 2, 132)]}


def device_us(fn, names, reps=20, before=None):
    """Device microseconds per call of fn for each kernel name (the
    profiler's CUDA events whose name holds it); `before`, if given, runs
    ahead of each call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if before:
                before()
            fn()
        torch.cuda.synchronize()
    events = cs._device_events(prof.key_averages())
    return {n: sum(cs._dev_us(e) for e in events if n in e.key) / reps
            for n in names}


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    actioner = cs.Actioner(cs.CONFIG, cli_opts=cs.CLI_OPTS, device="cuda",
                           seed=0)
    obs = [cs.synthetic_observation(100 + i) for i in range(4)]
    actioner.rng = np.random.default_rng(0)
    fwd = cs.capture_main_path(
        lambda: actioner.predict(**cs.requests(obs)[0]))
    batch = cs.capture_main_path(
        lambda: actioner.predict_batch(cs.requests(obs)))
    del actioner
    trainer, batches, _ = cs.build_trainer(cs.train_config(), cs.SPEC,
                                           device="cuda")
    host = next(batches)
    step = cs.capture(lambda: trainer.step(cs.batch_to_device(host, "cuda")),
                      [(cs.sparse_conv, "stem_conv", "stem_conv")])
    del trainer, batches
    stems = {1: fwd["stem_conv"][0], 4: batch["stem_conv"][0],
             32: step["stem_conv"][0][0]}

    rows = []

    def out(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    k1 = fwd["patch_attention"]
    for warps in (1, 2, 4, 8):
        total = 0.0
        for q, k, v, kv, scale in k1:
            splits = -(-q.shape[2] // (16 * warps))
            total += device_us(lambda: attention.patch_attention_split(
                q, k, v, kv, scale, warps, splits),
                ["patch_attention_kernel"])["patch_attention_kernel"]
        out({"kernel": "K1", "per": "B = 1 forward", "warps": warps,
             "device_us": total})
    a = torch.randn(4096, 128, device="cuda")
    for cold in (False, True):
        total = sum(device_us(lambda: attention.patch_attention(*c),
                              ["patch_attention_kernel"],
                              before=(lambda: a @ a.T) if cold else None)
                    ["patch_attention_kernel"] for c in k1)
        out({"kernel": "K1", "per": "B = 1 forward", "plan": "wrapper",
             "after_matmul": cold,
             "splits": [list(attention.attention_query_split(
                 *c[0].shape[:3])) for c in k1], "device_us": total})

    for B, (x, idx, ok, w) in stems.items():
        _, N, cin = x.shape
        K, _, cout = w.shape
        own = stem.stem_conv_plan(B, N, K, cin, cout)
        for plan in K3_PLANS[B] + [own]:
            t = device_us(lambda: stem.stem_conv_split(x, idx, ok, w, *plan),
                          ["stem_conv_kernel", "stem_conv_sum"],
                          reps=20 if B < 32 else 5)
            out({"kernel": "K3", "B": B, "plan": list(plan),
                 "wrapper": plan == own, "main_us": t["stem_conv_kernel"],
                 "sum_us": t["stem_conv_sum"],
                 "device_us": t["stem_conv_kernel"] + t["stem_conv_sum"]})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k1_k3_plans.json"),
              "w") as f:
        json.dump({"device": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
