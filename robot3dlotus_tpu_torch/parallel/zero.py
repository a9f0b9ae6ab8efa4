"""ZeRO-1 optimizer-state sharding on the port's flat optimizers (port of
robot3dlotus_tpu/parallel/zero.py and of the GSPMD ZeRO-1 layout of
robot3dlotus_tpu/parallel/mesh.py state_shardings).

Every optimizer of train/optim.py keeps its state in flat fp32 buffers
over the parameters in named_parameters() order. Under a mesh
(parallel/mesh.py) a FlatShard says which part of those buffers this
process holds and runs the collectives of the update:

  * the flat fp32 gradient over this process's parameters (its tp shards
    under tensor parallelism), zero-padded to a multiple of dp, is divided
    by dp and reduce-scattered over the dp group into this process's
    contiguous shard: the mean of the dp processes' gradients (the
    trainer scales each backward by dp, so that mean is the gradient of
    the whole batch's loss);
  * the moments, Lookahead's slow weights and MultiSteps' accumulator
    live on the shard only (1/dp of them on each process), and the core
    update runs on it, the weight decay and Ralamb's trust ratio against
    the same slice of the parameters;
  * the update of the shard is all-gathered back and added to the
    parameters, which stay whole over dp.

Norms. The global-norm clip takes the shard's sum of squares and one
scalar all_reduce; under tp the sum over every process counts each
tp-sharded element once and each replicated one tp times, so the
replicated part is divided by tp (JAX's zero.py counts its dp-replicated
leaves once alike). Ralamb and RangerLars take per-leaf norms: a shard
cuts the leaves at arbitrary offsets, so each leaf's sum of squares over
its piece of the shard (fp64) is all_reduced as one (L,) vector, the
replicated leaves' again divided by tp. So every optimizer of the menu
runs sharded with the update of the whole-buffer one (JAX's GSPMD
default runs them all).

Two formulations, as in JAX:
  * the default (TRAIN.zero1_manual False): the one-process step's
    numbers (JAX's GSPMD ZeRO-1): the batch norms and the losses' counts
    span the dp group, the optimizer's own clip;
  * manual (TRAIN.zero1_manual, JAX's make_manual_zero1_train_step): a
    pure-dp mesh; each process's losses are the mean over its own shard
    and enter with equal weight (the mean of the rank means), its batch
    norms normalise with its own shard's statistics and the running
    statistics are averaged over dp after the step, the global-norm clip
    (clip_norm) runs on the reduce-scattered gradient before the core
    update, and only the elementwise optimizers (MANUAL_OPTIMIZERS) run,
    with the optax chain's layout (no clip link; the fused AdamW's flat
    layout cannot hold a shard). The trainer (train/trainer.py) runs the
    step side of it.

Checkpoints keep the JAX per-leaf (and flat_adamw) layouts whatever the
shards: whole() gathers a buffer into the whole model's flat layout
(every process of the mesh takes part), local() cuts one back, so a
state saved at W = 2 resumes at W = 1 and the other way round
(convert.StateLayout).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as tdist
import torch.nn.functional as F

from . import dist

MANUAL_OPTIMIZERS = ("adamw", "adam", "adamax", "radam")


class FlatShard:
    """The part of a flat optimizer's buffers one process holds, and the
    update's collectives. leaves: [(local shape, tp dim or None)] of the
    optimizer's parameters in order (tp dim: the dim sharded over tp);
    the buffers are sharded over the mesh's dp group (its one process at
    dp = 1); clip_norm: the manual step's global-norm clip of the
    reduce-scattered gradient."""

    def __init__(self, leaves: Sequence[Tuple[tuple, Optional[int]]], mesh,
                 clip_norm=None):
        self.shapes = [tuple(s) for s, _ in leaves]
        self.tp_dims = [d for _, d in leaves]
        self.sizes = [int(torch.Size(s).numel()) for s in self.shapes]
        self.total = sum(self.sizes)
        self.mesh = mesh
        self.clip_norm = float(clip_norm) if clip_norm else None
        self.n = -(-self.total // mesh.dp)
        self.lo = min(mesh.dp_index * self.n, self.total)
        self.hi = min(self.lo + self.n, self.total)
        self.pad = self.n - (self.hi - self.lo)
        segs, off = [], 0
        for size in self.sizes:
            segs.append(max(0, min(off + size, self.hi) - max(off, self.lo)))
            off += size
        self.segs = segs
        self.tp = mesh.tp
        self._tp_mask = None
        if self.tp > 1:
            self._tp_mask = self._per_leaf_flags(
                [d is not None for d in self.tp_dims])
            self._tp_leaf = torch.tensor(
                [d is not None for d in self.tp_dims])
        self.whole_shapes = [self._whole_shape(s, d)
                             for s, d in zip(self.shapes, self.tp_dims)]

    def _whole_shape(self, shape, d):
        if d is None:
            return shape
        return shape[:d] + (shape[d] * self.tp,) + shape[d + 1:]

    def _per_leaf_flags(self, flags):
        return torch.cat([torch.full((s,), bool(f)) for f, s in
                          zip(flags, self.segs)] + [torch.zeros(
                              self.pad, dtype=torch.bool)])

    # -- buffers --

    def shard_of(self, full):
        """This process's shard (n,) of a (total,) buffer, zero-padded."""
        return F.pad(full[self.lo:self.hi], (0, self.pad))

    def per_element(self, vec):
        """(L,) per-leaf values -> (n,) over the shard's elements (0 in
        the padding)."""
        out = torch.repeat_interleave(
            vec, torch.as_tensor(self.segs, device=vec.device),
            output_size=self.n - self.pad)
        return F.pad(out, (0, self.pad))

    def pieces(self, shard):
        """The shard's piece of each leaf (empty where it holds none)."""
        return list(shard[:self.n - self.pad].split(self.segs))

    # -- the update's collectives --

    def scatter(self, g):
        """The flat (total,) fp32 gradient of this process -> its shard of
        the mean over the dp group; clipped by clip_norm when set."""
        mesh = self.mesh
        if mesh.dp_group is dist.LOCAL:
            g = self.shard_of(g)
        else:
            g = dist.reduce_scatter_sum(F.pad(
                g / mesh.dp, (0, self.n * mesh.dp - self.total)),
                mesh.dp_group)
        if self.clip_norm:
            gnorm = self.sumsq(g).sqrt()
            g = g * (self.clip_norm / gnorm.clamp(min=self.clip_norm))
        return g

    def gather(self, u):
        """The shard's update (n,) -> the whole (total,) update."""
        if self.mesh.dp_group is dist.LOCAL:
            return u[:self.total]
        return dist.all_gather_flat(u, self.mesh.dp_group)[:self.total]

    def _world_sum(self, v):
        """v summed over the processes whose buffers make up the whole
        model's: the dp shards of every tp shard."""
        mesh = self.mesh
        if mesh.dp_group is dist.LOCAL:
            return v
        return dist.all_reduce_sum(v, tdist.group.WORLD if self.tp > 1
                                   else mesh.dp_group)

    def sumsq(self, g):
        """The whole model's sum of squares of the buffer whose shard is
        g (a 0-d fp32 tensor)."""
        if self.tp == 1:
            return self._world_sum(g.square().sum())
        sq = g.square()
        zero = torch.zeros((), dtype=sq.dtype, device=sq.device)
        if self._tp_mask.device != g.device:
            self._tp_mask = self._tp_mask.to(g.device)
            self._tp_leaf = self._tp_leaf.to(g.device)
        mask = self._tp_mask
        v = self._world_sum(torch.stack([torch.where(mask, sq, zero).sum(),
                                         torch.where(mask, zero, sq).sum()]))
        return v[0] + v[1] / self.tp

    def leaf_norms(self, flat):
        """Each leaf's L2 norm (L,) fp32 of the buffer whose shard is
        flat: per-leaf fp64 sums of squares over the shard, summed over
        the mesh."""
        sq = torch.stack(torch._foreach_norm(
            [p.double() for p in self.pieces(flat)])).square()
        sq = self._world_sum(sq)
        if self.tp > 1:
            sq = torch.where(self._tp_leaf.to(sq.device), sq, sq / self.tp)
        return sq.sqrt().float()

    # -- the whole model's layout (checkpoints) --

    def whole(self, buf):
        """The whole model's flat buffer (in the optimizer's order, each
        leaf at its whole shape) of the buffer whose shard is buf; every
        process of the mesh takes part."""
        full = self.gather(buf)
        if self.tp == 1:
            return full
        ranks = dist.all_gather_tensor(full, self.mesh.tp_group)
        out, off = [], 0
        for shape, size, d in zip(self.shapes, self.sizes, self.tp_dims):
            parts = [r[off:off + size].view(shape) for r in ranks]
            out.append(parts[0] if d is None else torch.cat(parts, d))
            off += size
        return torch.cat([t.reshape(-1) for t in out])

    def local(self, whole):
        """The inverse of whole(): a whole flat buffer -> this process's
        buffer."""
        if self.tp > 1:
            parts, off = [], 0
            for shape, d in zip(self.whole_shapes, self.tp_dims):
                size = int(torch.Size(shape).numel())
                t = whole[off:off + size].view(shape)
                if d is not None:
                    n = shape[d] // self.tp
                    t = t.narrow(d, self.mesh.tp_index * n, n)
                parts.append(t.reshape(-1))
                off += size
            whole = torch.cat(parts)
        return self.shard_of(whole)


def flat_shard(named_params, mesh, plan=None, clip_norm=None):
    """The FlatShard of an optimizer over named_params [(name, parameter)]
    under `mesh`; plan: the model's {name: tp dim}
    (parallel/mesh.shard_model)."""
    plan = plan or {}
    return FlatShard([(tuple(p.shape), plan.get(n)) for n, p in named_params],
                     mesh, clip_norm=clip_norm)


def check_manual(train_cfg, mesh):
    """Raises unless the manual step can run: a pure-dp mesh and an
    elementwise optimizer (JAX asserts the same)."""
    if mesh.tp != 1 or mesh.sp != 1:
        raise ValueError("TRAIN.zero1_manual shards over dp only: it needs a "
                         f"pure-dp mesh (got {mesh.shape})")
    name = str(train_cfg.get("optim", "adamw"))
    if name not in MANUAL_OPTIMIZERS:
        raise ValueError(f"TRAIN.zero1_manual supports the elementwise "
                         f"optimizers {MANUAL_OPTIMIZERS} only; {name!r} "
                         "needs whole-tensor norms")


def manual_train_cfg(train_cfg):
    """The optimizer config of the manual step: its clip moves into the
    step (FlatShard.clip_norm) and the per-leaf chain's layout is kept
    (JAX's create_train_state(zero1_manual=True))."""
    return dict(train_cfg, grad_norm=None, fused_optim=False)


def average_stats(model, mesh):
    """The running statistics averaged over the dp group (the manual
    step's pmean of its batch_stats)."""
    if mesh.dp_group is dist.LOCAL:
        return
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if "running_" in name:
                buf.copy_(dist.sum_across(buf, mesh.dp_group) / mesh.dp)


def state_bytes(optimizer) -> int:
    """The bytes of the optimizer's state buffers on this process."""
    seen, total = set(), 0
    stack = [optimizer]
    while stack:
        o = stack.pop()
        if id(o) in seen:
            continue
        seen.add(id(o))
        for k, v in vars(o).items():
            if isinstance(v, torch.Tensor) and k in (
                    "mu", "nu", "slow", "acc"):
                total += v.numel() * v.element_size()
            elif k in ("inner", "base"):
                stack.append(v)
    return total
