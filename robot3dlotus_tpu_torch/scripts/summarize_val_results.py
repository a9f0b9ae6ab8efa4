"""Validation-sweep summarizer (the port's copy of
robot3dlotus_tpu/scripts/summarize_val_results.py).

Reads a results.jsonl of {checkpoint, task, variation, num_demos, sr} rows
covering several checkpoints, prints the per-taskvar SR matrix across
checkpoints and the best checkpoint by average SR.

  python -m robot3dlotus_tpu_torch.scripts.summarize_val_results \
      --result_file experiments/.../preds/seed100/results.jsonl
"""
from __future__ import annotations

import argparse
import json
import os
import re
from collections import defaultdict

import numpy as np


def _ckpt_step(ckpt):
    """'model_step_150000(.msgpack/.pt)' or int -> step int."""
    if isinstance(ckpt, (int, np.integer)) or ckpt is None:
        return ckpt
    m = re.search(r"(\d+)", os.path.basename(str(ckpt)))
    return int(m.group(1)) if m else ckpt


def load_results(result_file, ckpt_step=None):
    """-> {checkpoint: [(task, variation, sr, num_demos)]}, first record per
    (checkpoint, taskvar) wins (resumed runs append duplicates)."""
    results = defaultdict(list)
    seen = set()
    with open(result_file) as f:
        for line in f:
            item = json.loads(line)
            step = _ckpt_step(item.get("checkpoint"))
            if ckpt_step is not None and step != ckpt_step:
                continue
            key = (item.get("checkpoint"), item["task"], item["variation"])
            if key in seen:
                continue
            seen.add(key)
            results[item.get("checkpoint")].append(
                (item["task"], item["variation"], item["sr"],
                 item.get("num_demos", 0)))
    return results


def summarize(results, aggr_task=False):
    """-> (sorted ckpts, sorted taskvars, sr_matrix {taskvar: [sr per ckpt]},
    avg {ckpt: mean sr}, best (ckpt, sr))."""
    ckpts = sorted(results.keys(), key=lambda c: (_ckpt_step(c) is None,
                                                  _ckpt_step(c)))
    taskvars = sorted({(x[0],) if aggr_task else (x[0], x[1])
                       for rows in results.values() for x in rows})
    matrix = {}
    for tv in taskvars:
        row = []
        for ckpt in ckpts:
            srs = [x[2] for x in results[ckpt]
                   if (x[0],) == tv or (x[0], x[1]) == tv]
            row.append(float(np.mean(srs)) if srs else float("nan"))
        matrix[tv] = row
    avg = {ckpt: float(np.mean([x[2] for x in rows]))
           for ckpt, rows in results.items()}
    best = max(avg.items(), key=lambda kv: kv[1]) if avg else (None, 0.0)
    return ckpts, taskvars, matrix, avg, best


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--result_file", required=True)
    parser.add_argument("--ckpt_step", type=int, default=None)
    parser.add_argument("--aggr_task", action="store_true",
                        help="aggregate variations of the same task")
    args = parser.parse_args(argv)

    results = load_results(args.result_file, args.ckpt_step)
    ckpts, taskvars, matrix, avg, best = summarize(results, args.aggr_task)

    print("checkpoints:", ", ".join(str(c) for c in ckpts))
    for tv, row in matrix.items():
        name = tv[0] if args.aggr_task else f"{tv[0]}+{tv[1]}"
        print(f"{name}: " + ", ".join(f"{x*100:.2f}" for x in row))
    print()
    for ckpt in ckpts:
        print(ckpt, len(results[ckpt]), f"{avg[ckpt]*100:.2f}")
    print("\nBest checkpoint and SR")
    print(best[0], f"{best[1]*100:.2f}")
    return best


if __name__ == "__main__":
    main()
