#!/usr/bin/env python3
"""Time the bf16 paths of K1, K5 and K2 of two trees of the PyTorch port on
one card, in turns, on the same captured main-path calls.

    python3 scripts/torch_bf16_kernels_ab.py PARENT_ROOT CHANGE_ROOT \
        [--order pccp]

Each root is a checkout of the repo (e.g. `git archive` of a commit
unpacked into a git-ignored directory). First a process of the second
root captures, with chip_smoke.py's recorders, the kernel calls of one
`Actioner.predict` of the release policy at compute_dtype bfloat16 (B = 1,
seed-0 weights, chip_smoke's first synthetic observation: K1's and K2's
calls) and of one training step of the release trainer at bf16 (B = 32 x
4096 on synthetic_reach, release dropout: K5's calls, and K2's with their
cotangents), and saves them under build/bf16_ab/. Each turn of --order
(p: the first root, c: the second) is then a fresh Python process with
that root first on sys.path, which loads the calls and times that tree's
kernels on them: CUDA events (chip_smoke.cuda_ms; the B = 1 calls the
median of 21 rounds of 10, the training calls of 5 rounds of 2) and the
profiler's device time (chip_smoke.device_ms), summed per forward or per
step: K1 and K2 at B = 1; K5 (patch_attention_dropout_fwd), K2's forward
and the mirrored K2 on the fp32 owner sums (the input gradient's launch,
conv._conv_forward) per training step. One JSON line per turn is printed
and all of them are written to chiprun_out/bf16_kernels_ab.json, with the
card's name and power limit. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CAPTURE = r"""
import os, sys
import numpy as np
import torch
root, path = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
os.chdir(root)
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
actioner = cs.Actioner(cs.CONFIG, cli_opts=cs.CLI_OPTS + cs.BF16_OPTS,
                       device="cuda", seed=0)
actioner.rng = np.random.default_rng(0)
obs = [cs.synthetic_observation(100)]
serving = cs.capture_main_path(
    lambda: actioner.predict(**cs.requests(obs)[0]))
del actioner
trainer, batches, _ = cs.build_trainer(cs.train_config(*cs.BF16_OPTS),
                                       cs.SPEC, device="cuda")
host, _ = cs.host_batches(batches, 1)
if hasattr(batches, "close"):
    batches.close()
step = cs.capture(lambda: trainer.step(cs.batch_to_device(host[0], "cuda")),
                  cs.TRAIN_SITES)
calls = {"k1": serving["patch_attention"], "k2_b1": serving["subm_conv"],
         "k5": [c for c, _ in step["attention"]],
         "k2_step": [c for c in step["subm_conv"] if c[1] is not None]}
torch.save(calls, path)
print({k: len(v) for k, v in calls.items()}, flush=True)
"""

TURN = r"""
import json, os, sys
import torch
root, path = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
os.chdir(root)
import chip_smoke as cs
from robot3dlotus_tpu_torch.ops import attention, conv, gather
torch.backends.cuda.matmul.allow_tf32 = False
cs.cuda_lib.library()
calls = torch.load(path)
train = dict(rounds=5, reps=2, warmup=1)


def timed(runs, name, also=(), timing=None):
    ms = [cs.cuda_ms(r, **(timing or {})) for r in runs]
    dev = [cs.device_ms(r, name, reps=4, also=also) for r in runs]
    return {"ms": sum(ms), "device_ms": None if None in dev else sum(dev),
            "calls": len(runs), "ms_per_call": ms, "device_per_call": dev}


def dx_run(call):
    (x, idx, ok, w, _), g = call
    centre = idx.shape[-1] // 2
    gv = torch.where(ok[..., centre, None], g, torch.zeros_like(g))
    gsum = gather.scatter_rows_add(gv, idx[..., centre], x.shape[1],
                                   torch.float32)
    wm = conv.mirror_weight(w)
    return lambda: conv._conv_forward(gsum, idx, ok, wm, None)


res = {
    "k1_b1": timed([lambda a=c: attention.patch_attention(*a)
                    for c in calls["k1"]], "patch_attention_kernel"),
    "k2_b1": timed([lambda a=c: conv.subm_conv(*a) for c in calls["k2_b1"]],
                   *cs.K2_PROFILE),
    "k5_step": timed([lambda a=c: attention.patch_attention_dropout_fwd(*a)
                      for c in calls["k5"]], "attn_drop_fwd",
                     timing=train),
    "k2_forward_step": timed([lambda a=c[0]: conv.subm_conv(*a)
                              for c in calls["k2_step"]], *cs.K2_PROFILE,
                             timing=train),
    "k2_dx_step": timed([dx_run(c) for c in calls["k2_step"]],
                        *cs.K2_PROFILE, timing=train)}
print(json.dumps(res), flush=True)
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--order", default="pccp")
    args = ap.parse_args()
    roots = {"p": os.path.abspath(args.parent),
             "c": os.path.abspath(args.change)}
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    store = os.path.join(here, "build", "bf16_ab")
    os.makedirs(store, exist_ok=True)
    path = os.path.join(store, "calls.pt")
    subprocess.run([sys.executable, "-c", CAPTURE, roots["c"], path],
                   check=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    turns = []
    for t in args.order:
        out = subprocess.run([sys.executable, "-c", TURN, roots[t], path],
                             check=True, capture_output=True, text=True)
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["turn"] = t
        turns.append(res)
        print(json.dumps({k: (v if not isinstance(v, dict) else
                              {x: v[x] for x in ("ms", "device_ms")})
                          for k, v in res.items()}), flush=True)
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "bf16_kernels_ab.json"),
              "w") as f:
        json.dump({"card": smi, "roots": roots, "turns": turns}, f,
                  indent=1)
    os.remove(path)
    print(smi)


if __name__ == "__main__":
    main()
