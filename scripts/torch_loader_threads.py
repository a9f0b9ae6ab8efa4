#!/usr/bin/env python3
"""What the training data path costs a step on one card, at the release
width (train_simple_policy, B = 32 clouds x 4096 points, synthetic_reach).

    python3 scripts/torch_loader_threads.py [--steps 8] [--rounds 2]

1. host: the training loader alone (driver.build_loader, host structure
   on; nothing else running), ms per host batch with 0 and with 4 worker
   processes (the release TRAIN.n_workers);
2. device step: 5 steps on batches already on the card, p50, with the
   host idle, then with a 4-worker loader making batches beside the steps
   (a thread that keeps pulling batches), at the interpreter's default
   switch interval and at SWITCH_S;
3. entry: chip_smoke.entry_phase (train_simple_policy.main, launch counts
   checked, end-to-end clouds/s over the second half) in turns of
   settings, `rounds` times:
     serial  host batches made in series on the training thread, copied
             with batch_to_device (the loop before the prefetch);
     w0      the prefetch thread, the loader in series inside it;
     w4      the prefetch thread, 4 loader worker processes (the release
             YAML);
     w4s     as w4 with sys.setswitchinterval(SWITCH_S);
     w1      the prefetch thread, 1 loader worker process.
Prints the card's name and power limit and one JSON line per measurement;
writes chiprun_out/loader_threads.json. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

SWITCH_S = 0.0005


def loader(workers):
    return iter(cs.driver.build_loader(
        cs.train_config("TRAIN.n_workers", str(workers)), cs.SPEC))


def host_rate(workers, n=6):
    it = loader(workers)
    next(it)                                  # the pool's start
    t0 = time.perf_counter()
    for _ in range(n):
        next(it)
    it.close()
    return (time.perf_counter() - t0) * 1e3 / n


def device_steps(trainer, dev, busy, switch):
    """Step p50 on device batches; busy: a 4-thread loader pulls batches
    in a thread meanwhile."""
    stop = threading.Event()
    made = [0]

    def pull():
        it = loader(4)
        while not stop.is_set():
            next(it)
            made[0] += 1
        it.close()
    th = threading.Thread(target=pull, daemon=True) if busy else None
    old = sys.getswitchinterval()
    sys.setswitchinterval(switch)
    try:
        if th is not None:
            th.start()
            time.sleep(2.0)                   # the pool at work
        ms = []
        for b in dev:
            t0 = time.perf_counter()
            trainer.step(b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        stop.set()
        if th is not None:
            th.join(timeout=60)
        sys.setswitchinterval(old)
    return {"busy": busy, "switch_s": switch, "step_ms": ms,
            "step_ms_p50": float(np.median(ms)), "batches_made": made[0]}


def entry(setting, steps):
    workers = {"serial": 0, "w0": 0, "w4": 4, "w4s": 4, "w1": 1}[setting]
    config = lambda *o: cs.train_config("TRAIN.n_workers", str(workers),  # noqa
                                        *o)
    old = sys.getswitchinterval()
    if setting == "w4s":
        sys.setswitchinterval(SWITCH_S)
    try:
        out = cs.entry_phase(config=config, steps=steps,
                             per_step=cs.PER_STEP, tag=setting,
                             serial=setting == "serial")
    finally:
        sys.setswitchinterval(old)
    return {"setting": setting, "n_workers": workers,
            **{k: out[k] for k in ("clouds_per_s", "step_ms",
                                   "host_ms_per_batch", "batch_wait_ms")}}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_loader_threads: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    results = {"device": smi, "default_switch_s": sys.getswitchinterval()}

    results["host_ms_per_batch"] = {w: host_rate(w) for w in (0, 4)}
    print(json.dumps({"host_ms_per_batch": results["host_ms_per_batch"]}),
          flush=True)

    trainer, batches, _ = cs.build_trainer(cs.train_config(), cs.SPEC,
                                           device="cuda")
    host = [next(batches) for _ in range(6)]
    batches.close()
    dev = [cs.batch_to_device(b, "cuda") for b in host]
    trainer.step(dev[0])                      # warm-up
    torch.cuda.synchronize()
    results["device_step"] = []
    for busy, switch in ((False, sys.getswitchinterval()),
                         (True, sys.getswitchinterval()),
                         (True, SWITCH_S), (False, sys.getswitchinterval())):
        r = device_steps(trainer, dev[1:], busy, switch)
        results["device_step"].append(r)
        print(json.dumps(r), flush=True)
    del trainer, dev, host
    torch.cuda.empty_cache()

    results["entry"] = []
    order = ["serial", "w0", "w4", "w4s", "w1"]
    for rnd in range(args.rounds):
        for setting in (order if rnd % 2 == 0 else order[::-1]):
            r = entry(setting, args.steps)
            results["entry"].append(r)
            print(json.dumps({k: r[k] for k in ("setting", "clouds_per_s",
                                                "step_ms")}), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "loader_threads.json"),
              "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
