"""The process mesh and the tensor-parallel rules (port of
robot3dlotus_tpu/parallel/mesh.py: parse_mesh_spec, mesh_from_spec,
make_mesh, the TP rules, and stage_eval_batch as eval_rows / gather_rows).

A mesh is the processes of the joined group arranged dp x sp x tp in
JAX's order: the process of rank (dp_i sp + sp_i) tp + tp_i sits at
(dp_i, sp_i, tp_i). make_mesh cuts the group into the subgroups the
step reduces over: each process's dp group (the dp processes with its
tp index, which hold the same tp shards and the shards of one batch) and
its tp group (the tp processes with its dp index, which hold the same
points). The trainer takes the dp group as its batch group
(parallel/dist.py), so that the masked batch norms and the losses sum
over the dp processes only. Sequence parallelism (sp > 1) is not ported
and raises.

Tensor parallelism, Megatron's column / row pairs where JAX's rules put
them (robot3dlotus_tpu/parallel/mesh.py _TP_RULES):
  MLP: fc1 (kernel (C, hidden), bias) column-parallel, fc2's kernel
    (hidden, C) row-parallel, in every Block and every CABlock (the rule
    matches both MLPs);
  CPE: cpe_conv (weight (K, Cin, Cout), bias) column-parallel on Cout,
    cpe_fc's kernel (Cout, C) row-parallel.
The port's parameters carry the flax names (convert.flax_leaves), and a
Dense's torch weight is the flax kernel transposed, so the rule's dim
-1 of fc1's kernel is dim 0 of its weight and dim 0 of fc2's and
cpe_fc's kernels dim 1 of theirs; cpe_conv's weight keeps (K, Cin, Cout).
The row-parallel biases (fc2, cpe_fc) stay whole and are added once,
after the sum (models/layers.py). JAX tests the divisibility of each leaf;
the port shards a pair when the tp size divides its width (fc1's output,
cpe_conv's Cout), which every leaf of the pair carries, and
check_tp_plan holds the pairs against the rules leaf by leaf.
Attention, the norms, the heads and the CABlocks' attention stay whole
on every process.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as tdist

from . import dist

AXES = ("dp", "sp", "tp")
SP_NOT_PORTED = ("sequence parallelism (sp > 1) is not ported to the "
                 "PyTorch package; ROADMAP.md §1 queues it")

# (flax path-suffix regex, dim of the flax leaf) — JAX's _TP_RULES
TP_RULES = (
    (r"mlp/fc1/kernel$", -1),
    (r"mlp/fc1/bias$", -1),
    (r"mlp/fc2/kernel$", 0),
    (r"cpe_conv/weight$", -1),
    (r"cpe_conv/bias$", -1),
    (r"cpe_fc/kernel$", 0),
)


def parse_mesh_spec(spec: str) -> dict:
    """'dp=2,tp=2' / 'tp=4' / 'sp=2,tp=2' -> make_mesh kwargs. Axes left
    out default to 1 except dp, which absorbs the remaining processes when
    omitted (make_mesh's own default)."""
    kw = {}
    for part in spec.replace(";", ",").split(","):
        part = part.strip()
        if not part:
            continue
        k, eq, v = part.partition("=")
        k = k.strip()
        if k not in AXES:
            raise ValueError(f"unknown mesh axis {k!r} in {spec!r}")
        if not eq or not v.strip().isdigit() or int(v) < 1:
            raise ValueError(
                f"mesh axis {k!r} needs a positive size (got {part!r} "
                f"in {spec!r})")
        kw[k] = int(v)
    return kw


@dataclass
class Mesh:
    """This process's place in a dp x sp x tp mesh and its subgroups
    (dist.LOCAL for a group of this process alone without a process
    group)."""
    dp: int
    tp: int
    sp: int
    dp_index: int
    tp_index: int
    dp_group: object
    tp_group: object

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "sp": self.sp, "tp": self.tp}


def make_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1) -> Mesh:
    """The mesh over every process of the joined group (one process
    without a group); dp defaults to the processes left after tp and sp.
    Every process must call it, in the same order as its other group
    calls (the subgroups are made collectively). Raises for sp > 1 and
    for sizes whose product is not the number of processes."""
    if sp != 1:
        raise ValueError(SP_NOT_PORTED)
    n = dist.world_size()
    if dp is None:
        dp = n // (tp * sp)
    if dp < 1 or dp * tp * sp != n:
        raise ValueError(
            f"a dp={dp} x sp={sp} x tp={tp} mesh needs {max(dp, 1) * sp * tp}"
            f" processes; {n} joined (launch them with torchrun or SLURM, "
            "one a card)")
    if not dist.joined():
        return Mesh(1, 1, 1, 0, 0, dist.LOCAL, dist.LOCAL)
    rank = dist.rank()
    dp_index, tp_index = divmod(rank, tp)
    dp_group = tp_group = None
    for t in range(tp):                       # collective: every process
        g = tdist.new_group([d * tp + t for d in range(dp)])
        if t == tp_index:
            dp_group = g
    for d in range(dp):
        g = tdist.new_group([d * tp + t for t in range(tp)])
        if d == dp_index:
            tp_group = g
    return Mesh(dp, tp, sp, dp_index, tp_index, dp_group, tp_group)


def mesh_from_spec(spec) -> Mesh:
    """A Mesh from a spec string or dict (a Mesh passes through). The
    port's mesh spans every process of the group: an explicit dp must
    make the product the number of processes."""
    if isinstance(spec, Mesh):
        return spec
    kw = parse_mesh_spec(spec) if isinstance(spec, str) else dict(spec)
    return make_mesh(**kw)


# --- tensor parallelism ----------------------------------------------------

@dataclass
class TPShard:
    """What a module with a column / row pair needs to run its share: the
    tp group, this process's index in it and its size."""
    group: object
    rank: int
    size: int

    def cols(self, width):
        """This process's slice of a dimension of `width` (its whole
        width)."""
        n = width // self.size
        return slice(self.rank * n, (self.rank + 1) * n)


def rule_dim(path: str, ndim: int, transposed: bool) -> Optional[int]:
    """The torch dim that JAX's TP rules shard for a leaf at the flax
    `path`, or None: the rule's flax dim, mirrored for a transposed (Dense)
    weight."""
    for pat, dim in TP_RULES:
        if re.search(pat, path):
            d = dim % ndim
            return (ndim - 1 - d) if transposed else d
    return None


def tp_pairs(model):
    """[(module, {parameter name: torch dim}, width)] of the model's
    column / row pairs: each MLP's fc1 and fc2, each Block's cpe_conv
    and cpe_fc."""
    from ..models.layers import MLP, Block
    out = []
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, MLP):
            leaves = {f"{pre}fc1.weight": 0, f"{pre}fc2.weight": 1}
            if mod.fc1.bias is not None:
                leaves[f"{pre}fc1.bias"] = 0
            out.append((mod, leaves, mod.fc1.weight.shape[0]))
        elif isinstance(mod, Block):
            leaves = {f"{pre}cpe_conv.weight": 2, f"{pre}cpe_fc.weight": 1}
            if mod.cpe_conv.bias is not None:
                leaves[f"{pre}cpe_conv.bias"] = 0
            out.append((mod, leaves, mod.cpe_conv.weight.shape[2]))
    return out


def tp_plan(model, tp: int) -> Dict[str, int]:
    """{parameter name: torch dim} of every leaf sharded over `tp`
    processes: the pairs the tp size divides."""
    plan = {}
    if tp > 1:
        for _, leaves, width in tp_pairs(model):
            if width % tp == 0:
                plan.update(leaves)
    return plan


def check_tp_plan(model, tp: int, plan: Dict[str, int]):
    """Raises unless `plan` shards exactly the leaves, on the dims, that
    JAX's tp_leaf_spec shards for the model's flax names and shapes."""
    from ..convert import flax_leaves
    want = {}
    if tp > 1:
        params = dict(model.named_parameters())
        for name, (coll, path, transposed) in flax_leaves(model).items():
            if coll != "params":
                continue
            shape = params[name].shape
            d = rule_dim("/".join(path), len(shape), transposed)
            if d is not None and shape[d] % tp == 0:
                want[name] = d
    if want != plan:
        diff = sorted(set(want.items()) ^ set(plan.items()))
        raise ValueError(f"tp={tp}: the pairs shard other leaves than JAX's "
                         f"rules: {diff[:6]}")


def shard_model(model, mesh: Mesh):
    """Slices the model's pair leaves in place to this process's tp shard
    (whole weights in, as every process built or loaded them) and sets
    each pair's module to run its tensor-parallel form; returns the
    model. Without tp (tp = 1) the model stays whole. model.tp_plan is
    the {name: dim} of the sliced leaves."""
    plan = tp_plan(model, mesh.tp)
    check_tp_plan(model, mesh.tp, plan)
    model.tp_plan, model.tp_mesh = plan, mesh
    if not plan:
        return model
    shard = TPShard(mesh.tp_group, mesh.tp_index, mesh.tp)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, d in plan.items():
            p = params[name]
            p.data = p.data[(slice(None),) * d + (
                shard.cols(p.shape[d]),)].contiguous()
    for mod, leaves, width in tp_pairs(model):
        if width % mesh.tp == 0:
            mod.tp = shard
    return model


def _tp_of(model):
    plan = getattr(model, "tp_plan", None) or {}
    return plan, getattr(model, "tp_mesh", None)


def whole_state_dict(model, tensors=None):
    """model.state_dict() (or `tensors`, a dict by parameter name, such as
    the gradients) with every tp-sharded leaf gathered whole (on every
    process of the tp group; a collective there)."""
    sd = model.state_dict() if tensors is None else tensors
    plan, mesh = _tp_of(model)
    if not plan:
        return sd
    out = dict(sd)
    for name, d in plan.items():
        out[name] = torch.cat(dist.all_gather_tensor(sd[name], mesh.tp_group),
                              d)
    return out


def shard_state_dict(model, state_dict):
    """A whole state_dict cut to this process's tp shards (the model's
    plan); the state_dict itself for a whole model."""
    plan, mesh = _tp_of(model)
    if not plan:
        return state_dict
    shard = TPShard(mesh.tp_group, mesh.tp_index, mesh.tp)
    out = dict(state_dict)
    for name, d in plan.items():
        t = state_dict[name]
        out[name] = t[(slice(None),) * d + (shard.cols(t.shape[d]),)]
    return out


# --- sharded serving --------------------------------------------------------

def eval_rows(B: int, mesh: Mesh) -> slice:
    """The rows of a B-row serving batch this process computes: its dp
    share when dp divides B, else all of them (replicated over dp), as
    JAX's stage_eval_batch commits them."""
    if mesh.dp > 1 and B % mesh.dp == 0:
        n = B // mesh.dp
        return slice(mesh.dp_index * n, (mesh.dp_index + 1) * n)
    return slice(0, B)


def gather_rows(local, B: int, mesh: Mesh):
    """The B rows of every process's `local` rows (eval_rows) in order,
    on every process: an all_gather over the dp group when the rows were
    split, `local` itself when they were replicated."""
    if not (mesh.dp > 1 and B % mesh.dp == 0):
        return local
    return torch.cat(dist.all_gather_tensor(local, mesh.dp_group), 0)
