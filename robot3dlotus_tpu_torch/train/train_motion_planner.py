"""3D-LOTUS++ motion-planner training entry point (port of
robot3dlotus_tpu/train/train_motion_planner.py):

    python -m robot3dlotus_tpu_torch.train.train_motion_planner \\
        --exp-config <yaml> [--device cpu] [KEY VALUE]...

The policy's loop (driver.run_training) with the motion dataset, collate,
trajectory loss, decode and validation metrics (open and stop accuracy
over valid trajectory steps). Runs on the CUDA card unless --device cpu is
given. The data comes from TRAIN_DATASET.data_dir: a directory of GemBench
LMDB environments (motion_keysteps_bbox_pcd), a msgpack directory, or
'synthetic_motion' (train/datasets/store.py open_store).
"""
from __future__ import annotations

import numpy as np

from ..models.motion_planner import compute_mp_loss, decode_mp_actions
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


def _val_accuracy(actions, batch):
    """Decoded (B, L, 9) trajectories -> open/stop accuracy over valid
    trajectory steps (JAX train_motion_planner._val_accuracy)."""
    tmask = batch["traj_masks"].astype(bool) & \
        batch["batch_valid"].astype(bool)[:, None]
    gt_open = batch["gt_trajs"][..., -1] > 0.5
    gt_stop = batch["gt_trajs_stop"] > 0.5
    open_pred = (1.0 / (1.0 + np.exp(-actions[..., -2]))) > 0.5
    stop_pred = (1.0 / (1.0 + np.exp(-actions[..., -1]))) > 0.5
    n = float(tmask.sum())
    return {
        "open_acc": (float(np.sum((open_pred == gt_open) & tmask)), n),
        "stop_acc": (float(np.sum((stop_pred == gt_stop) & tmask)), n),
    }


SPEC = TaskSpec(name="motion_planner", build_dataset=_build_dataset,
                make_collate=_make_collate, loss_fn=compute_mp_loss,
                decode_fn=decode_mp_actions, val_accuracy=_val_accuracy)


def main(config, device="cuda"):
    return run_training(config, SPEC, device=device)


if __name__ == "__main__":
    main(*build_args())
