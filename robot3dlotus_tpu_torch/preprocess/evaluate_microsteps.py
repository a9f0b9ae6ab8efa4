"""Microstep replay validator (the port's copy of
robot3dlotus_tpu/preprocess/evaluate_microsteps.py): replay each demo's
recorded gripper poses open-loop and record the achievable success rate per
taskvar, a data-quality check of an episode store ("can the demos be
executed open-loop?").

The simulator of the JAX package's validator (RLBench) is not available to
the port, so the episodes play on ReplayEnv (eval/server.py) over the
store:

  python -m robot3dlotus_tpu_torch.preprocess.evaluate_microsteps \\
      --microstep_data_dir <episode store> [--result_file <jsonl>]
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ..eval.common import write_to_file


class MicrostepReplayActioner:
    """Returns the recorded next gripper pose at every step: from an
    episode store (`store`), or from the RLBench demo files under
    microstep_data_dir (low_dim_obs.pkl)."""

    def __init__(self, microstep_data_dir=None, store=None):
        self.microstep_data_dir = microstep_data_dir
        self.store = store
        self.actions = None

    def _load_actions(self, task_str, variation, episode_id):
        if self.store is not None:
            rec = self.store.get(f"{task_str}+{variation}",
                                 episode_id if isinstance(episode_id, str)
                                 else f"episode{episode_id}")
            return [np.asarray(a) for a in np.asarray(rec["action"])[1:]]
        path = os.path.join(
            self.microstep_data_dir, task_str, f"variation{variation}",
            "episodes", str(episode_id), "low_dim_obs.pkl")
        with open(path, "rb") as f:
            low_dim_obs = pickle.load(f)
        return [np.hstack([x.gripper_pose, x.gripper_open])
                for x in low_dim_obs[1:]]

    def predict(self, task_str=None, variation=None, step_id=0,
                obs_state_dict=None, episode_id=None, instructions=None):
        if step_id == 0:
            self.actions = self._load_actions(task_str, variation, episode_id)
        if step_id < len(self.actions):
            return {"action": self.actions[step_id]}
        # past the recorded poses: the zero action fails the episode
        return {"action": np.zeros(8, np.float32)}


def evaluate_microsteps(args):
    """Every episode of every taskvar of the store, replayed on ReplayEnv
    for at most max_steps steps; one {"taskvar", "sr"} row a taskvar in
    the result file. Returns {taskvar: sr}."""
    from ..eval.server import ReplayEnv
    from ..train.datasets.store import open_store

    store = open_store(args.microstep_data_dir)
    env = ReplayEnv(store)
    actioner = MicrostepReplayActioner(store=store)
    result_file = args.result_file or os.path.join(
        args.microstep_data_dir, "taskvar_srs.jsonl")
    srs = {}
    for taskvar in store.taskvars():
        task_str, variation = taskvar.split("+")
        episodes = store.episodes(taskvar)
        success = 0
        for demo_id, episode in enumerate(episodes):
            obs = env.reset(task_str, int(variation), demo_id)
            reward = 0.0
            for step_id in range(args.max_steps):
                out = actioner.predict(task_str, variation, step_id, obs,
                                       episode_id=episode)
                obs, reward, done = env.step(out["action"])
                if done or reward == 1:
                    break
            success += int(reward == 1)
        srs[taskvar] = success / max(len(episodes), 1)
        print(taskvar, srs[taskvar] * 100)
        write_to_file(result_file, {"taskvar": taskvar, "sr": srs[taskvar]})
    env.close()
    return srs


def build_parser(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--microstep_data_dir", required=True,
                        help="episode store: LMDB or msgpack directory")
    parser.add_argument("--result_file", default=None,
                        help="default <microstep_data_dir>/taskvar_srs.jsonl")
    parser.add_argument("--max_steps", type=int, default=1000)
    return parser.parse_args(argv)


if __name__ == "__main__":
    evaluate_microsteps(build_parser())
