"""3D-LOTUS++ pipeline evaluation server CLI (the port's copy of
robot3dlotus_tpu/eval/eval_robot_pipeline_server.py).

  python -m robot3dlotus_tpu_torch.eval.eval_robot_pipeline_server \\
      --pipeline_config_file \\
          robot3dlotus_tpu_torch/configs/rlbench/robot_pipeline_gt.yaml \\
      --mp_expr_dir experiments/gembench/3dlotusplus/v1 --mp_ckpt_step N \\
      --taskvar_file assets/taskvars_train.json --env replay \\
      --replay_data_dir <motion episode store> [--device cpu]

The per-episode pipeline cache round-trips through the producer/consumer
queues (stateful=True). The prediction directory encodes the oracle modes,
as in the JAX package:
  preds[-llm_gt][-og_gt_<label_type>][-runstepN]/seed<S>/results.jsonl
The pipeline is build_pipeline's: GroundtruthRobotPipeline under
ground-truth grounding (robot_pipeline_gt.yaml), else RobotPipeline
(robot_pipeline.yaml: VLM grounding), which needs OWLv2 and SAM backends
that a command line cannot inject, so such a config raises here, naming
the weights (build_pipeline and serving.ThreeDLotusPlusActioner take
injected backends). `--env rlbench` raises. This module imports no
torch.
"""
from __future__ import annotations

import argparse
import os
from functools import partial

import yaml

from ..utils.assets import resolve_asset
from .eval_simple_policy_server import (RLBENCH_UNAVAILABLE, load_taskvars,
                                        replay_env_builder, report)
from .server import run_eval_server
from .serving import build_pipeline, model_checkpoint, require_backends


def build_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pipeline_config_file", required=True)
    p.add_argument("--mp_expr_dir", default=None)
    p.add_argument("--mp_ckpt_step", type=int, default=None)
    p.add_argument("--taskvar_file", default="assets/taskvars_train.json")
    p.add_argument("--taskvar", default=None)
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--num_demos", type=int, default=20)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--max_steps", type=int, default=25)
    p.add_argument("--run_action_step", type=int, default=1)
    p.add_argument("--no_gt_llm", action="store_true")
    p.add_argument("--llm_cache_file", default=None)
    p.add_argument("--gt_og_label_file", default=None)
    p.add_argument("--pc_label_type", default=None)
    p.add_argument("--save_obs_outs", action="store_true")
    p.add_argument("--env", default="rlbench", choices=["rlbench", "replay"])
    p.add_argument("--replay_data_dir", default=None)
    p.add_argument("--image_size", type=int, nargs=2, default=[256, 256])
    p.add_argument("--device", default="cuda",
                   help="the consumer's device (cuda, or cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = build_args(argv)
    if args.env == "rlbench":
        raise NotImplementedError(RLBENCH_UNAVAILABLE)
    with open(resolve_asset(args.pipeline_config_file)) as f:
        pipeline_config = yaml.safe_load(f)

    llm_cfg = pipeline_config.setdefault("llm_planner", {})
    og_cfg = pipeline_config.setdefault("object_grounding", {})
    mp_cfg = pipeline_config.setdefault("motion_planner", {})
    if args.no_gt_llm:
        llm_cfg["use_groundtruth"] = False
    if args.llm_cache_file is not None:
        llm_cfg["cache_file"] = args.llm_cache_file
    require_backends(pipeline_config)   # here, not in the consumer
    if args.gt_og_label_file is not None:
        og_cfg["gt_label_file"] = args.gt_og_label_file
    if args.pc_label_type is not None:
        mp_cfg["pc_label_type"] = args.pc_label_type
    mp_cfg["run_action_step"] = args.run_action_step

    mp_expr_dir = args.mp_expr_dir or mp_cfg.get("expr_dir")
    mp_ckpt_step = args.mp_ckpt_step if args.mp_ckpt_step is not None \
        else mp_cfg.get("ckpt_step")
    checkpoint = model_checkpoint(mp_expr_dir, mp_ckpt_step)
    if checkpoint is None:
        print(os.path.join(mp_expr_dir, "ckpts",
                           f"model_step_{mp_ckpt_step}.msgpack"),
              "not exists")
        return None
    mp_cfg["expr_dir"] = mp_expr_dir
    mp_cfg["ckpt_step"] = mp_ckpt_step
    mp_cfg["checkpoint"] = checkpoint
    mp_cfg["config_file"] = os.path.join(
        mp_expr_dir, "logs", "training_config.yaml")
    mp_cfg["save_obs_outs"] = args.save_obs_outs

    pred_dirname = "preds"
    if llm_cfg.get("use_groundtruth", False):
        pred_dirname += "-llm_gt"
    if og_cfg.get("use_groundtruth", False):
        pred_dirname += f"-og_gt_{mp_cfg.get('pc_label_type', 'coarse')}"
    if args.run_action_step > 1:
        pred_dirname += f"-runstep{args.run_action_step}"
    pred_dir = os.path.join(mp_expr_dir, pred_dirname, f"seed{args.seed}")
    os.makedirs(pred_dir, exist_ok=True)
    mp_cfg["pred_dir"] = pred_dir
    result_file = os.path.join(pred_dir, "results.jsonl")

    taskvars = load_taskvars(args.taskvar, args.taskvar_file)
    from ..configs import get_config
    data_cfg = get_config(mp_cfg["config_file"]).TRAIN_DATASET
    env_builder = partial(
        replay_env_builder, args.replay_data_dir or data_cfg.get("data_dir"),
        llm_cfg.get("taskvar_instr_file"))

    report(run_eval_server(
        taskvars, partial(build_pipeline, pipeline_config, args.device),
        env_builder, result_file, num_workers=args.num_workers,
        num_demos=args.num_demos, max_steps=args.max_steps, seed=args.seed,
        checkpoint=mp_ckpt_step, stateful=True))
    return result_file


if __name__ == "__main__":
    main()
