"""Model factory (port of robot3dlotus_tpu/models/factory.py
`build_model`), for the classes this port serves."""
from __future__ import annotations

import torch

from .motion_planner import MotionPlanner
from .simple_policy import SimplePolicy

_VARIANTS = {"SimplePolicyPTV3CA": SimplePolicy,
             "MotionPlannerPTV3CA": MotionPlanner}


def resolve_device(device):
    """torch.device for an entry point; a CUDA device without a card is an
    error, never a quiet switch to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port's plain PyTorch path")
    return device


def build_model(model_cfg, device="cuda", seed=0):
    """model_cfg: ConfigNode/dict with model_class, ptv3_config,
    action_config. Weights are initialised on the CPU from `seed` (the JAX
    package's init distributions) and moved to `device`; the model is in
    eval mode."""
    device = resolve_device(device)
    cls = model_cfg["model_class"]
    if cls not in _VARIANTS:
        raise NotImplementedError(f"{cls}: the port serves "
                                  f"{sorted(_VARIANTS)}")
    gen = torch.Generator().manual_seed(seed)
    model = _VARIANTS[cls](dict(model_cfg["ptv3_config"]),
                           dict(model_cfg["action_config"]), gen)
    return model.to(device).eval()
