"""Fixed-shape collation (the port's copy of
robot3dlotus_tpu/train/datasets/collate.py): variable-length host samples
-> padded numpy batches of num_clouds clouds x num_points points, text
lengths bucketed to powers of two. Short batches repeat the last sample,
with batch_valid marking the real ones.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

TXT_BUCKETS = (4, 8, 16, 32, 80)


def _bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def collate_keystep_samples(samples: List[Dict], num_points: int,
                            txt_buckets: Sequence[int] = TXT_BUCKETS,
                            num_clouds: int = None) -> Dict[str, np.ndarray]:
    B = num_clouds or len(samples)
    batch_valid = np.zeros(B, bool)
    batch_valid[:min(len(samples), B)] = True
    samples = (samples + [samples[-1]] * max(0, B - len(samples)))[:B]

    N = num_points
    cin = samples[0]["pc_fts"].shape[-1]
    T = _bucket(max(s["txt_embeds"].shape[0] for s in samples), txt_buckets)
    td = samples[0]["txt_embeds"].shape[-1]

    pc = np.zeros((B, N, cin), np.float32)
    mask = np.zeros((B, N), bool)
    counts = np.zeros(B, np.int32)
    txt = np.zeros((B, T, td), np.float32)
    txt_mask = np.zeros((B, T), bool)
    ee = np.zeros((B, 8), np.float32)
    gt = np.zeros((B, samples[0]["gt_actions"].shape[-1]), np.float32)
    steps = np.zeros(B, np.int32)
    centroids = np.zeros((B, 3), np.float32)
    radius = np.zeros(B, np.float32)
    has_rm = "robot_point_mask" in samples[0]
    robot_mask = np.zeros((B, N), bool) if has_rm else None

    for i, s in enumerate(samples):
        n = min(s["pc_fts"].shape[0], N)
        pc[i, :n] = s["pc_fts"][:n]
        mask[i, :n] = True
        counts[i] = n
        t = min(s["txt_embeds"].shape[0], T)
        txt[i, :t] = s["txt_embeds"][:t]
        txt_mask[i, :t] = True
        ee[i] = s["ee_poses"][:8] if s["ee_poses"].shape[-1] >= 8 else \
            np.pad(s["ee_poses"], (0, 8 - s["ee_poses"].shape[-1]))
        gt[i] = s["gt_actions"]
        steps[i] = s["step_ids"]
        centroids[i] = s["pc_centroids"]
        radius[i] = s["pc_radius"]
        if has_rm:
            robot_mask[i, :n] = s["robot_point_mask"][:n]

    out = {
        "pc_fts": pc, "pc_mask": mask, "pc_counts": counts,
        "txt_embeds": txt, "txt_mask": txt_mask, "ee_poses": ee,
        "gt_actions": gt, "step_ids": steps, "batch_valid": batch_valid,
        "pc_centroids": centroids, "pc_radius": radius,
    }
    if has_rm:
        out["pc_robot_mask"] = robot_mask
    return out
