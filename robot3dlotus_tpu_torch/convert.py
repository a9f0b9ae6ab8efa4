"""Carry JAX (flax) variables across into the PyTorch port.

The port's submodules carry the flax module names, so the map is
mechanical: the '/'-joined flax path becomes the '.'-joined torch name and
only the leaf is renamed:
  Dense `kernel` (in, out)     -> `weight`, transposed to (out, in)
  LayerNorm / BN `scale`       -> `weight`
  BN batch_stats `mean`/`var`  -> `running_mean` / `running_var`
  SubMConv `weight` (K, Cin, Cout) and every `bias` keep name and layout.
"""
from __future__ import annotations

import numpy as np
import torch

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "weight": "weight"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(variables):
    """{params, batch_stats} nested dicts of arrays -> the port's
    state_dict (torch float32 tensors on the CPU)."""
    out = {}
    for path, leaf in _flatten(variables["params"]):
        arr = np.array(leaf, np.float32)
        if path[-1] == "kernel":
            arr = arr.T
        out[".".join(path[:-1] + (_PARAM_LEAF[path[-1]],))] = \
            torch.from_numpy(np.ascontiguousarray(arr))
    for path, leaf in _flatten(variables.get("batch_stats", {})):
        out[".".join(path[:-1] + (_STAT_LEAF[path[-1]],))] = \
            torch.from_numpy(np.array(leaf, np.float32))
    return out
