"""3D-LOTUS policy training entry point (port of
robot3dlotus_tpu/train/train_simple_policy.py):

    python -m robot3dlotus_tpu_torch.train.train_simple_policy \\
        --exp-config <yaml> [--device cpu] [KEY VALUE]...

Runs on the CUDA card unless --device cpu is given. The data comes from
TRAIN_DATASET.data_dir: a directory of GemBench LMDB environments (the
release layout), a msgpack directory, or a synthetic store ('synthetic',
'synthetic_reach[N]'); train/datasets/store.py open_store. The loop and its run control
(checkpoints in output_dir, resume, validation) are driver.run_training's;
this module contributes the keystep dataset, collate, loss, decode and the
validation metrics (pos L1, open accuracy).
"""
from __future__ import annotations

import numpy as np

from ..models.simple_policy import compute_loss, decode_actions
from .datasets.collate import collate_keystep_samples
from .datasets.keystep_dataset import KeystepDataset
from .datasets.store import open_store
from .driver import TaskSpec, build_args, run_training


def _build_dataset(ds_cfg, rng):
    cfg = dict(ds_cfg)
    store = open_store(cfg.pop("data_dir"))
    return KeystepDataset(store, rng=rng, **cfg)


def _make_collate(ds_cfg, num_clouds):
    num_points = int(ds_cfg.get("num_points", 4096))
    return lambda samples: collate_keystep_samples(
        samples, num_points, num_clouds=num_clouds)


def _val_accuracy(actions, batch):
    """Decoded (B, 8) actions -> pos L1 + open accuracy over valid clouds
    (JAX train_simple_policy._val_accuracy)."""
    bv = batch["batch_valid"].astype(bool)
    gt = batch["gt_actions"]
    open_pred = (1.0 / (1.0 + np.exp(-actions[:, -1]))) > 0.5
    open_hits = float(np.sum((open_pred == (gt[:, -1] > 0.5)) & bv))
    pos_l1 = float(np.sum(
        np.abs(actions[:, :3] - gt[:, :3]).mean(-1) * bv))
    n = float(bv.sum())
    return {"open_acc": (open_hits, n), "pos_l1_loss": (pos_l1, n)}


SPEC = TaskSpec(name="simple_policy", build_dataset=_build_dataset,
                make_collate=_make_collate, loss_fn=compute_loss,
                decode_fn=decode_actions, val_accuracy=_val_accuracy)


def main(config, device="cuda"):
    return run_training(config, SPEC, device=device)


if __name__ == "__main__":
    main(*build_args())
