"""3D-LOTUS++ motion-planner training entry point (port of
robot3dlotus_tpu/train/train_motion_planner.py):

    python -m robot3dlotus_tpu_torch.train.train_motion_planner \\
        --exp-config <yaml> [--device cpu] [KEY VALUE]...

The policy's loop (driver.run_training) with the motion dataset, collate
and trajectory loss. Runs on the CUDA card unless --device cpu is given.
The data comes from TRAIN_DATASET.data_dir, which the port reads for the
synthetic stores only ('synthetic_motion'). Validation waits with the
policy's.
"""
from __future__ import annotations

import logging

from ..models.motion_planner import compute_mp_loss
from .datasets.motion_dataset import (MotionPlannerDataset,
                                      collate_motion_samples)
from .datasets.store import open_store
from .driver import TaskSpec, build_args, run_training


def _build_dataset(ds_cfg, rng):
    cfg = dict(ds_cfg)
    store = open_store(cfg.pop("data_dir"))
    return MotionPlannerDataset(store, rng=rng, **cfg)


def _make_collate(ds_cfg, num_clouds):
    num_points = int(ds_cfg.get("num_points", 4096))
    max_traj_len = int(ds_cfg.get("max_traj_len", 5))
    return lambda samples: collate_motion_samples(
        samples, num_points, max_traj_len, num_clouds=num_clouds)


SPEC = TaskSpec(name="motion_planner", build_dataset=_build_dataset,
                make_collate=_make_collate, loss_fn=compute_mp_loss)


def main(config, device="cuda"):
    return run_training(config, SPEC, device=device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main(*build_args())
