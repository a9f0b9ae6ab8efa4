"""Host-chosen order shuffle and SFC presort of a training batch (the port
of the part of robot3dlotus_tpu/train/datasets/structure.py
`attach_host_structure` that decides results).

TRAIN.host_structure (default True, as in the JAX driver) draws ONE order
permutation per collated batch from RandomState(SEED + 131071), in batch
order, and presorts every cloud's per-point rows by the SFC code of the
chosen first order. The model takes the batch's `order_perm`: it permutes
its codes by it, skips the stage-0 entry sort and redraws at no pooling
stage (children inherit the parent's sort). With the key False the model
redraws the orders at stage 0 and after every pooling instead.

The JAX package also ships the stem and per-stage CPE neighbour maps built
on the host (`stem_nmap`, `cpe_nmap{s}`); the port builds the same maps on
the device (bit-identical), so it attaches none.

The per-cloud sorts do not depend on the batch: `attach_sample_orders`
computes each cloud's stable argsort in every order where the episode is
loaded (the loader's worker processes), and attach_host_structure then
only reorders rows in the parent. A cloud without them (serial loading)
is sorted in place; both give the same rows.
"""
from __future__ import annotations

import numpy as np

from ...ops.sfc_np import SFC_ORDERS, sfc_encode_np

# per-point batch keys that ride the presort permutation
_POINT_KEYS = ("pc_fts", "robot_point_mask", "pc_robot_mask", "pc_labels")
ORDERS_KEY = "sfc_orders"


def structure_cfg_from_model(model_cfg):
    """MODEL config node -> what the presort needs: the orders, the serial
    depth, the grid size and whether orders are shuffled."""
    p3 = dict(model_cfg["ptv3_config"])
    act = dict(model_cfg["action_config"])
    return dict(
        orders=tuple(p3.get("order") or p3.get("orders") or SFC_ORDERS),
        serial_depth=int(p3.get("serial_depth", 10)),
        grid_size=float(act.get("voxel_size", 0.01)),
        shuffle=bool(p3.get("shuffle_orders", True)))


def _cloud_codes(xyz, order, cfg):
    """SFC codes of one cloud: the float32 grid math of
    models.ptv3.compute_grid_coord."""
    depth = cfg["serial_depth"]
    xyz = np.asarray(xyz, np.float32)
    gc = np.floor((xyz - xyz.min(0, keepdims=True)) /
                  np.float32(cfg["grid_size"])).astype(np.int32)
    np.clip(gc, 0, (1 << depth) - 1, out=gc)
    return sfc_encode_np(gc, order, depth)


def cloud_orders(xyz, cfg):
    """(num_orders, n) int32: the stable argsort of the cloud's code in
    each of cfg's orders."""
    return np.stack([np.argsort(_cloud_codes(xyz, o, cfg), kind="stable")
                     for o in cfg["orders"]]).astype(np.int32)


def attach_sample_orders(cfg, samples):
    """An episode's samples with each cloud's cloud_orders under
    ORDERS_KEY (the loader's per-episode hook, run in its workers)."""
    for s in samples:
        s[ORDERS_KEY] = cloud_orders(s["pc_fts"][:, :3], cfg)
    return samples


def attach_host_structure(batch, cfg, rng, sample_orders=None):
    """Draws the batch's order permutation from `rng`, presorts every
    cloud's per-point rows by the chosen first order's code and attaches
    `order_perm`. sample_orders: per cloud, its cloud_orders or None (then
    computed here). Mutates `batch` (numpy arrays) and returns it."""
    orders = cfg["orders"]
    perm = (rng.permutation(len(orders)) if cfg.get("shuffle", True)
            else np.arange(len(orders))).astype(np.int32)
    first = int(perm[0])
    counts = np.asarray(batch["pc_counts"])
    for b in range(len(counts)):
        n = int(counts[b])
        if n == 0:
            continue
        pre = None if sample_orders is None else sample_orders[b]
        if pre is not None and pre.shape[1] == n:
            o = pre[first]
        else:
            o = np.argsort(_cloud_codes(batch["pc_fts"][b, :n, :3],
                                        orders[first], cfg), kind="stable")
        for key in _POINT_KEYS:
            if key in batch:
                batch[key][b, :n] = batch[key][b, :n][o]
    batch["order_perm"] = perm
    return batch


class HostStructureCollate:
    """collate_fn(chunk) followed by attach_host_structure with the draws
    of `rng`, fed the chunk's per-cloud orders where the loader attached
    them (short chunks repeat their last sample, as the collates do)."""

    def __init__(self, collate_fn, cfg, rng):
        self.collate_fn, self.cfg, self.rng = collate_fn, cfg, rng

    def __call__(self, chunk):
        batch = self.collate_fn(chunk)
        B = len(batch["pc_counts"])
        padded = (list(chunk) + [chunk[-1]] * B)[:B]
        return attach_host_structure(
            batch, self.cfg, self.rng,
            [s.get(ORDERS_KEY) for s in padded])
