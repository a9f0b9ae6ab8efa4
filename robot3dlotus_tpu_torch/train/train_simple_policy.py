"""3D-LOTUS policy training entry point (port of
robot3dlotus_tpu/train/train_simple_policy.py):

    python -m robot3dlotus_tpu_torch.train.train_simple_policy \\
        --exp-config <yaml> [--device cpu] [KEY VALUE]...

Runs on the CUDA card unless --device cpu is given. The data comes from
TRAIN_DATASET.data_dir, which the port reads for the synthetic stores only
('synthetic', 'synthetic_reach[N]').
"""
from __future__ import annotations

import argparse
import logging

from ..configs import get_config
from ..models.simple_policy import compute_loss
from .datasets.collate import collate_keystep_samples
from .datasets.keystep_dataset import KeystepDataset
from .datasets.store import open_store
from .driver import TaskSpec, run_training


def build_args(argv=None):
    """-> (config, device)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--exp-config", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="KEY VALUE overrides")
    args = parser.parse_args(argv)
    return get_config(args.exp_config, args.opts), args.device


def _build_dataset(ds_cfg, rng):
    cfg = dict(ds_cfg)
    store = open_store(cfg.pop("data_dir"))
    return KeystepDataset(store, rng=rng, **cfg)


def _make_collate(ds_cfg, num_clouds):
    num_points = int(ds_cfg.get("num_points", 4096))
    return lambda samples: collate_keystep_samples(
        samples, num_points, num_clouds=num_clouds)


SPEC = TaskSpec(name="simple_policy", build_dataset=_build_dataset,
                make_collate=_make_collate, loss_fn=compute_loss)


def main(config, device="cuda"):
    return run_training(config, SPEC, device=device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main(*build_args())
