"""Constants of the VLM grounding pipeline (the port's copy of
robot3dlotus_tpu/vlm/configs.py): the workspace, the table, the detector's
post-processing and the box-cleaning, merging, DBSCAN and outlier
thresholds of the RLBench and real-robot setups."""
from __future__ import annotations

import numpy as np

from ..configs.rlbench.constants import get_robot_workspace


def _ws_array(ws):
    return np.array([
        [ws["X_BBOX"][0], ws["Y_BBOX"][0], ws["Z_BBOX"][0]],
        [ws["X_BBOX"][1], ws["Y_BBOX"][1], ws["Z_BBOX"][1]],
    ])


class VLMRLBenchConfig:
    robot_workspace = get_robot_workspace(real_robot=False)
    workspace = _ws_array(robot_workspace)
    table_height = robot_workspace["TABLE_HEIGHT"]
    voxel_size = 0.01
    det_postprocess = dict(
        threshold=0.1, target_sizes=None, min_size_ratio=None,
        max_size_ratio=0.8, min_return_topk=1, max_return_topk=10,
        use_nms=True, nms_sigma=0.2, nms_thresh=0.1,
    )
    table_dist_threshold = 0.0025
    clean_det_config = dict(max_out_workspace_ratio=0.2, max_robot_ratio=0.5,
                            max_table_ratio=0.5)
    merge_obj_config = dict(chamfer_dist_measure="min",
                            max_match_pcd_dist=0.02, min_match_embed_sim=0.6)
    dbscan_config = dict(eps=0.02, min_samples=5, min_keep_ratio=0.3)
    pcd_min_num_points = 20
    pcd_outlier_removal_config = dict(nb_neighbors=50, std_ratio=0.2)


class VLMRealConfig(VLMRLBenchConfig):
    robot_workspace = get_robot_workspace(real_robot=True, use_vlm=True)
    workspace = _ws_array(robot_workspace)
    table_height = robot_workspace["TABLE_HEIGHT"]
    det_postprocess = dict(
        threshold=0.15, target_sizes=None, min_size_ratio=None,
        max_size_ratio=0.8, min_return_topk=1, max_return_topk=10,
        use_nms=True, nms_sigma=0.2, nms_thresh=0.1,
    )
    clean_det_config = dict(max_out_workspace_ratio=0.35, max_robot_ratio=0.5,
                            max_table_ratio=0.75)
    merge_obj_config = dict(chamfer_dist_measure="min",
                            max_match_pcd_dist=0.1, min_match_embed_sim=0.8)
    dbscan_config = dict(eps=0.015, min_samples=5, min_keep_ratio=0.4)
