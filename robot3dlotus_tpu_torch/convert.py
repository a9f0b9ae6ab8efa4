"""Carry variables between JAX (flax) trees and the PyTorch port.

The port's submodules carry the flax module names, so the map is
mechanical: the '/'-joined flax path becomes the '.'-joined torch name and
only the leaf is renamed:
  Dense `kernel` (in, out)     -> `weight`, transposed to (out, in)
  LayerNorm / BN `scale`       -> `weight`
  Embed `embedding` (num, dim) -> `weight`, as it is
  BN batch_stats `mean`/`var`  -> `running_mean` / `running_var`
  SubMConv `weight` (K, Cin, Cout) and every `bias` keep name and layout.
`params_to_jax` is the inverse; it names a leaf by the type of the module
that holds it, since a torch `weight` can be any of the first four.

The optimizer state crosses too: the JAX flat_adamw keeps its moments as
one (Tpad,) buffer each, the leaves in jax.tree_util order (sorted paths),
Dense kernels as (in, out), zero-padded to a multiple of 4096; the port's
FlatAdamW keeps them unpadded in named_parameters() order, Linear weights
as (out, in). `adam_state_to_jax` / `adam_state_from_jax` move them leaf by
leaf, by name. The other optimizers' JAX states are optax chains of
per-leaf trees (the clip's, lr multipliers' and freeze mask's empty
states beside the core's) and optax.MultiSteps around them. Each port
optimizer writes and reads its own layout (state_tree / load_tree) through
a `StateLayout`; `opt_state_to_jax` / `opt_state_from_jax` call them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .models.layers import MaskedBatchNorm, SubMConv

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "weight": "weight", "embedding": "weight"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}
# module type -> {torch leaf: flax leaf}; running statistics go to
# batch_stats
_TO_FLAX = [(nn.Linear, {"weight": "kernel", "bias": "bias"}),
            ((nn.LayerNorm, MaskedBatchNorm),
             {"weight": "scale", "bias": "bias", "running_mean": "mean",
              "running_var": "var"}),
            (nn.Embedding, {"weight": "embedding"}),
            (SubMConv, {"weight": "weight", "bias": "bias"})]
FLAT_PAD = 4096   # the JAX flat_adamw's pad granule


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


def flax_leaves(model):
    """{state_dict name: (collection, flax path tuple, transposed)} for
    every parameter and running statistic of the model; raises on a module
    type the map does not know."""
    out = {}
    for mname, mod in model.named_modules():
        own = dict(mod.named_parameters(recurse=False))
        own.update(mod.named_buffers(recurse=False))
        if not own:
            continue
        leaves = next((m for t, m in _TO_FLAX if isinstance(mod, t)), None)
        if leaves is None or not set(own) <= set(leaves):
            raise TypeError(f"{mname or 'model'} ({type(mod).__name__}): no "
                            f"flax names for {sorted(own)}")
        prefix = tuple(mname.split(".")) if mname else ()
        for leaf in own:
            coll = "batch_stats" if leaf.startswith("running_") \
                else "params"
            name = f"{mname}.{leaf}" if mname else leaf
            out[name] = (coll, prefix + (leaves[leaf],),
                         leaves[leaf] == "kernel")
    return out


def params_to_jax(model):
    """The model's state -> {params, batch_stats} nested dicts of float32
    numpy arrays in flax names and layouts (the inverse of
    params_from_jax)."""
    out = {"params": {}, "batch_stats": {}}
    sd = model.state_dict()
    for name, (coll, path, transposed) in flax_leaves(model).items():
        t = sd[name].detach()
        arr = (t.t() if transposed else t).contiguous().cpu().numpy()
        node = out[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr.astype(np.float32, copy=False)
    return out


def _jax_flat_layout(model, optimizer):
    """[(port offset, size, parameter shape, transposed)] of each leaf in
    the JAX flat buffer's order, and the padded length Tpad."""
    leaves = flax_leaves(model)
    offsets, off = {}, 0
    for name, size in zip(optimizer.names, optimizer.sizes):
        offsets[name] = off
        off += size
    shapes = dict((n, p.shape) for n, p in zip(optimizer.names,
                                               optimizer.params))
    if set(offsets) != {n for n, v in leaves.items() if v[0] == "params"}:
        raise ValueError("the optimizer's parameters are not the model's")
    order = sorted(offsets, key=lambda n: leaves[n][1])
    layout = [(offsets[n], shapes[n].numel(), shapes[n], leaves[n][2])
              for n in order]
    return layout, -(-off // FLAT_PAD) * FLAT_PAD


def adam_state_to_jax(optimizer, model):
    """FlatAdamW's state -> the JAX flat_adamw state {count: int32 0-d,
    mu: (Tpad,), nu: (Tpad,)} as numpy arrays."""
    layout, tpad = _jax_flat_layout(model, optimizer)
    out = {"count": np.asarray(optimizer.count, np.int32)}
    for key in ("mu", "nu"):
        src = getattr(optimizer, key)
        flat = torch.zeros(tpad, dtype=torch.float32, device=src.device)
        j = 0
        for off, n, shape, transposed in layout:
            seg = src[off:off + n].view(shape)
            flat[j:j + n] = (seg.t() if transposed else seg).reshape(-1)
            j += n
        out[key] = flat.cpu().numpy()
    return out


def adam_state_from_jax(opt_state, optimizer, model):
    """Loads a JAX flat_adamw state ({count, mu, nu}) into FlatAdamW, on
    the optimizer's device; raises when the buffers do not fit the
    model."""
    layout, tpad = _jax_flat_layout(model, optimizer)
    moments = {}
    for key in ("mu", "nu"):
        arr = np.asarray(opt_state[key])
        if arr.shape != (tpad,) or arr.dtype != np.float32:
            raise ValueError(f"opt_state {key}: {arr.dtype} {arr.shape}, "
                             f"the model needs float32 ({tpad},)")
        moments[key] = torch.from_numpy(arr).to(getattr(optimizer,
                                                        key).device)
    count = np.asarray(opt_state["count"])
    if count.shape != () or count.dtype.kind not in "iu":
        raise ValueError(f"opt_state count: {count.dtype} {count.shape}")
    for key, flat in moments.items():
        dst = getattr(optimizer, key)
        j = 0
        for off, n, shape, transposed in layout:
            seg = flat[j:j + n]
            seg = seg.view(shape[1], shape[0]).t() if transposed \
                else seg.view(shape)
            dst[off:off + n].view(shape).copy_(seg)
            j += n
    optimizer.count = int(count)


def _leaf_layout(optimizer, model):
    """[(flax path, port offset, size, shape, transposed)] of each
    parameter in the optimizer's flat order."""
    leaves = flax_leaves(model)
    out, off = [], 0
    for name, p in zip(optimizer.names, optimizer.params):
        _, path, transposed = leaves[name]
        out.append((path, off, p.numel(), tuple(p.shape), transposed))
        off += p.numel()
    return out


def flat_to_tree(flat, optimizer, model):
    """A flat per-parameter buffer -> a float32 numpy tree in flax names
    and layouts (one copy off the device)."""
    host = flat.detach().float().cpu().numpy()
    tree = {}
    for path, off, n, shape, transposed in _leaf_layout(optimizer, model):
        arr = host[off:off + n].reshape(shape)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(arr.T if transposed else arr)
    return tree


def flat_from_tree(tree, optimizer, model, dst):
    """Copies a flax-layout tree (flat_to_tree's) into the flat buffer
    `dst` (one copy onto its device)."""
    host = np.empty(dst.numel(), np.float32)
    for path, off, n, shape, transposed in _leaf_layout(optimizer, model):
        node = tree
        for k in path:
            node = node[k]
        arr = np.asarray(node, np.float32)
        host[off:off + n] = (arr.T if transposed else arr).reshape(-1)
    dst.copy_(torch.from_numpy(host))


class StateLayout:
    """Moves a port optimizer's flat fp32 buffers to and from the JAX
    package's layouts for `model`: per-leaf flax trees (the optax chains,
    MultiSteps' accumulator) and flat_adamw's padded buffers. The
    optimizers' state_tree / load_tree take one."""

    def __init__(self, optimizer, model):
        self.optimizer, self.model = optimizer, model

    def tree(self, flat):
        return flat_to_tree(flat, self.optimizer, self.model)

    def load_tree(self, tree, dst):
        flat_from_tree(tree, self.optimizer, self.model, dst)

    def flat_adamw(self, optimizer):
        return adam_state_to_jax(optimizer, self.model)

    def load_flat_adamw(self, state, optimizer):
        adam_state_from_jax(state, optimizer, self.model)


def opt_state_to_jax(optimizer, model):
    """The port optimizer's state (train.optim.build_optimizer) -> the JAX
    build_optimizer's opt_state as flax writes it, numpy leaves."""
    return optimizer.state_tree(StateLayout(optimizer, model))


def _check_like(got, want, path="opt_state"):
    """Raises unless `got` has `want`'s keys, and its leaves their shapes
    and dtype kinds."""
    if isinstance(want, dict):
        keys = sorted(got) if hasattr(got, "items") else type(got).__name__
        if keys != sorted(want):
            raise KeyError(f"{path}: {keys}, this optimizer's state has "
                           f"{sorted(want)}")
        for k in want:
            _check_like(got[k], want[k], f"{path}/{k}")
        return
    a, b = np.asarray(got), np.asarray(want)
    if a.shape != b.shape or a.dtype.kind != b.dtype.kind:
        raise ValueError(f"{path}: {a.dtype} {a.shape}, this optimizer "
                         f"needs {b.dtype} {b.shape}")


def opt_state_from_jax(opt_state, optimizer, model):
    """Loads a JAX opt_state (opt_state_to_jax's layout, written by either
    package) into the port optimizer, on its device; raises when the
    state is another optimizer's or does not fit the model."""
    _check_like(opt_state, opt_state_to_jax(optimizer, model))
    optimizer.load_tree(opt_state, StateLayout(optimizer, model))
