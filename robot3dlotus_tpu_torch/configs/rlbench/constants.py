"""RLBench / real-robot workspace bounds: the port's copy of
robot3dlotus_tpu/configs/rlbench/constants.py get_robot_workspace
(facts about the simulator scenes, not code)."""


def get_robot_workspace(real_robot=False, use_vlm=False):
    if real_robot:
        if use_vlm:
            return {"TABLE_HEIGHT": 0.0, "X_BBOX": (-0.60, 0.2),
                    "Y_BBOX": (-0.54, 0.54), "Z_BBOX": (-0.02, 0.75)}
        return {"TABLE_HEIGHT": 0.01, "X_BBOX": (-0.60, 0.2),
                "Y_BBOX": (-0.54, 0.54), "Z_BBOX": (0, 0.75)}
    return {"TABLE_HEIGHT": 0.7505, "X_BBOX": (-0.5, 1.5),
            "Y_BBOX": (-1, 1), "Z_BBOX": (0.2, 2)}
