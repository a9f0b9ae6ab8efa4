"""Model factory (port of robot3dlotus_tpu/models/factory.py
`build_model`): the five model classes of the reference's MODEL_FACTORY."""
from __future__ import annotations

import torch

from .motion_planner import MotionPlanner
from .simple_policy import SimplePolicy

_VARIANTS = {
    "SimplePolicyPTV3AdaNorm": (SimplePolicy, "adanorm"),
    "SimplePolicyPTV3CA": (SimplePolicy, "ca"),
    "SimplePolicyPTV3Concat": (SimplePolicy, "concat"),
    "MotionPlannerPTV3AdaNorm": (MotionPlanner, "adanorm"),
    "MotionPlannerPTV3CA": (MotionPlanner, "ca"),
}


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
    cls, variant = _VARIANTS[model_cfg["model_class"]]
    gen = torch.Generator().manual_seed(seed)
    model = cls(dict(model_cfg["ptv3_config"]),
                dict(model_cfg["action_config"]), gen, variant)
    return model.to(device).eval()
