"""3D-LOTUS policy evaluation server CLI (the port's copy of
robot3dlotus_tpu/eval/eval_simple_policy_server.py).

  python -m robot3dlotus_tpu_torch.eval.eval_simple_policy_server \\
      --expr_dir experiments/gembench/3dlotus/v1 --ckpt_step 150000 \\
      --taskvar_file assets/taskvars_train.json --seed 100 \\
      --num_demos 20 --num_workers 4 --env replay \\
      --replay_data_dir <episode store> [--device cpu]

Reloads the training config from <expr_dir>/logs/training_config.yaml,
serves <expr_dir>/ckpts/model_step_<N>.msgpack (or .pt) with the port's
Actioner on --device (the card by default; no fallback to the CPU) in the
consumer process, skips the taskvars already recorded, and appends each
taskvar's success rate to <expr_dir>/preds/seed<S>/results.jsonl. Prints
one line `eval server: {...}` with what the server measured (requests/s,
per-request ms at the producers, the consumer's batches).

`--env replay` drives the recorded-episode ReplayEnv over an episode store
(--replay_data_dir, else the config's TRAIN_DATASET.data_dir);
`--env rlbench` raises: the RLBench simulator is not available to the
port. This module imports no torch: the producers it spawns stay off the
card.
"""
from __future__ import annotations

import argparse
import json
import os
from functools import partial

from ..utils.assets import resolve_asset
from .server import ReplayEnv, run_eval_server
from .serving import model_checkpoint

RLBENCH_UNAVAILABLE = (
    "--env rlbench: the RLBench simulator (CoppeliaSim, PyRep) is not "
    "available to the PyTorch port; evaluate on recorded episodes with "
    "--env replay --replay_data_dir <store>")


def build_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--expr_dir", required=True)
    p.add_argument("--ckpt_step", type=int, required=True)
    p.add_argument("--taskvar_file", default="assets/taskvars_train.json")
    p.add_argument("--taskvar", default=None,
                   help="evaluate a single task+variation instead")
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--num_demos", type=int, default=20)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--max_steps", type=int, default=25)
    p.add_argument("--num_ensembles", type=int, default=1)
    p.add_argument("--best_disc_pos", default="max", choices=["max", "ens1"])
    p.add_argument("--env", default="rlbench", choices=["rlbench", "replay"])
    p.add_argument("--replay_data_dir", default=None,
                   help="episode store for --env replay")
    p.add_argument("--save_obs_outs_dir", default=None)
    p.add_argument("--image_size", type=int, nargs=2, default=[256, 256])
    p.add_argument("--cam_rand_factor", type=float, default=0.0)
    p.add_argument("--device", default="cuda",
                   help="the consumer's device (cuda, or cpu)")
    p.add_argument("remained_args", nargs=argparse.REMAINDER,
                   help="KEY VALUE overrides merged into the train config")
    return p.parse_args(argv)


def _actioner_builder(exp_config, checkpoint, cli_opts, best_disc_pos,
                      num_ensembles, save_obs_outs_dir, device):
    from .actioner import Actioner
    return Actioner(
        exp_config, checkpoint=checkpoint, cli_opts=cli_opts,
        best_disc_pos=best_disc_pos, num_ensembles=num_ensembles,
        save_obs_outs_dir=save_obs_outs_dir, device=device)


def replay_env_builder(data_dir, taskvar_instr_file):
    """A ReplayEnv over the store at data_dir, with the taskvar
    instructions of taskvar_instr_file where it exists."""
    from ..train.datasets.store import open_store
    instrs = {}
    f = resolve_asset(taskvar_instr_file)
    if f and os.path.exists(f):
        with open(f) as fh:
            instrs = json.load(fh)
    return ReplayEnv(open_store(data_dir), taskvar_instructions=instrs)


def load_taskvars(taskvar, taskvar_file):
    if taskvar:
        return [taskvar]
    with open(resolve_asset(taskvar_file)) as f:
        return json.load(f)


def report(stats):
    """The `eval server: {...}` line of a run's summary (None: every
    taskvar was already done)."""
    if stats is None:
        print("eval server: {\"requests\": 0}", flush=True)
        return
    keep = {k: v for k, v in stats.items() if k != "request_ms"}
    print("eval server: " + json.dumps(keep), flush=True)


def main(argv=None):
    args = build_args(argv)
    if args.env == "rlbench":
        raise NotImplementedError(RLBENCH_UNAVAILABLE)
    exp_config = os.path.join(args.expr_dir, "logs", "training_config.yaml")
    checkpoint = model_checkpoint(args.expr_dir, args.ckpt_step)
    if checkpoint is None:
        print(os.path.join(args.expr_dir, "ckpts",
                           f"model_step_{args.ckpt_step}.msgpack"),
              "not exists")
        return None

    taskvars = load_taskvars(args.taskvar, args.taskvar_file)
    pred_dir = os.path.join(args.expr_dir, "preds", f"seed{args.seed}")
    os.makedirs(pred_dir, exist_ok=True)
    result_file = os.path.join(pred_dir, "results.jsonl")

    actioner_builder = partial(
        _actioner_builder, exp_config, checkpoint,
        args.remained_args or None, args.best_disc_pos, args.num_ensembles,
        args.save_obs_outs_dir, args.device)
    from ..configs import get_config
    data_cfg = get_config(exp_config).TRAIN_DATASET
    env_builder = partial(
        replay_env_builder, args.replay_data_dir or data_cfg.get("data_dir"),
        data_cfg.get("taskvar_instr_file"))

    report(run_eval_server(
        taskvars, actioner_builder, env_builder, result_file,
        num_workers=args.num_workers, num_demos=args.num_demos,
        max_steps=args.max_steps, seed=args.seed,
        checkpoint=f"model_step_{args.ckpt_step}"))
    return result_file


if __name__ == "__main__":
    main()
