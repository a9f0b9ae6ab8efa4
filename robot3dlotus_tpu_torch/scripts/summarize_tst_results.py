"""Test-split summarizer (the port's copy of
robot3dlotus_tpu/scripts/summarize_tst_results.py).

Aggregates results.jsonl over multiple test seeds (seed<k>/results.jsonl
under --result_dir) for one checkpoint step, and prints per-split (L1..L4)
mean/std success rates plus the over-seeds mean±std.

  python -m robot3dlotus_tpu_torch.scripts.summarize_tst_results \
      --result_dir experiments/.../preds --ckpt_step 150000 \
      --seeds 200 300 400 500 600
"""
from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np

from ..utils.assets import resolve_asset
from .summarize_val_results import _ckpt_step

SPLIT_NAMES = ["taskvars_train", "taskvars_test_l2", "taskvars_test_l3",
               "taskvars_test_l4"]


def load_seed_results(result_dir, seeds, ckpt_step):
    """-> {taskvar: [sr per seed]} for records matching ckpt_step."""
    results = defaultdict(list)
    for seed in seeds:
        result_file = os.path.join(result_dir, f"seed{seed}",
                                   "results.jsonl")
        if not os.path.exists(result_file):
            print(result_file, "missing")
            continue
        with open(result_file) as f:
            for line in f:
                item = json.loads(line)
                if _ckpt_step(item.get("checkpoint")) != ckpt_step:
                    continue
                results[f"{item['task']}+{item['variation']}"].append(
                    item["sr"])
    return results


def summarize_split(results, taskvars):
    """-> (per-taskvar mean%, per-taskvar std%, over-seed mean%, std%)."""
    means = [100 * np.mean(results[tv]) if results[tv] else float("nan")
             for tv in taskvars]
    stds = [100 * np.std(results[tv]) if results[tv] else float("nan")
            for tv in taskvars]
    num_seeds = min((len(results[tv]) for tv in taskvars), default=0)
    seed_means = [100 * np.mean([results[tv][i] for tv in taskvars])
                  for i in range(num_seeds)]
    return means, stds, (float(np.mean(seed_means)) if seed_means else
                         float("nan")), \
        (float(np.std(seed_means)) if seed_means else float("nan"))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--result_dir", required=True)
    parser.add_argument("--ckpt_step", type=int, required=True)
    parser.add_argument("--seeds", type=int, nargs="+",
                        default=[200, 300, 400, 500, 600])
    parser.add_argument("--splits", nargs="+", default=SPLIT_NAMES)
    args = parser.parse_args(argv)

    results = load_seed_results(args.result_dir, args.seeds, args.ckpt_step)
    out = {}
    for split in args.splits:
        split_file = resolve_asset(os.path.join("assets", f"{split}.json"))
        if not os.path.exists(split_file):
            print("split file missing:", split_file)
            continue
        taskvars = sorted(json.load(open(split_file)))
        means, stds, seed_mean, seed_std = summarize_split(results, taskvars)
        out[split] = (seed_mean, seed_std)
        print("split", split)
        print(",".join(["avg"] + taskvars))
        print(",".join(f"{x:.2f}" for x in [np.nanmean(means)] + means))
        print(",".join(f"{x:.2f}" for x in [np.nanmean(stds)] + stds))
        print(f"over seeds: {seed_mean:.2f} +- {seed_std:.2f}\n")
    return out


if __name__ == "__main__":
    main()
