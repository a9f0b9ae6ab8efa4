"""Processes training together (port of robot3dlotus_tpu/parallel/dist.py):
rank discovery from the launch environment, the process group, rank
gating, an all_gather of picklable objects, reduce_dict, the sums across
the processes that hold one batch, and Megatron's two operators of a
tensor-parallel pair.

One process a card: torchrun (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) or SLURM (SLURM_NTASKS, SLURM_PROCID, SLURM_LOCALID, the
first host of the node list) says how many processes there are and which
one this is; init_distributed joins them in one torch.distributed group,
NCCL on the card and gloo on the CPU. Without a group every function here
is the one-process case: no collective is called, and sum_across and
global_count return their argument itself.

The batch group. Each process runs the step on its own shard of the
batch, and the processes that hold the shards of one batch form the
batch group: every process of the group under pure data parallelism,
the dp group of a dp x tp mesh (parallel/mesh.py; the tp ranks of one dp
index hold the same points, so summing over them would count each point
tp times), and no process but this one under the manual ZeRO-1 step
(LOCAL: statistics and losses of the process's own shard, as
parallel/zero.py describes). The trainer (train/trainer.py) picks it from
its mesh and hands it on: to each masked batch norm's `group` attribute
(models/layers.py MaskedBatchNorm), which takes its sums over it with
sum_across, whose gradient is the sum of the group's (JAX's batch norm
under its dp mesh sums over the global batch alike), and to the losses'
`group` argument, whose global_count counts the group's batch, so that
the processes' losses add up to the loss of the whole batch (the trainer
scales the backward by the dp size, which the gradient's reduction, a
mean over the dp processes, undoes). A group of None is every process.

Tensor parallelism (parallel/mesh.py, models/layers.py MLP and Block):
copy_to_tp is Megatron's f (the identity forward, a sum over the tp
group backward) in front of a column-parallel layer, reduce_from_tp its
g (a sum over the tp group forward, the identity backward) behind the
row-parallel one. Every collective here raises where the backend cannot
run it; none is replaced by a copy.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as tdist


def joined():
    """Whether this process is in a process group."""
    return tdist.is_available() and tdist.is_initialized()


def rank():
    return tdist.get_rank() if joined() else 0


def world_size():
    return tdist.get_world_size() if joined() else 1


def local_rank():
    """This process's index on its host (its card): LOCAL_RANK
    (torchrun), SLURM_LOCALID, else 0."""
    for key in ("LOCAL_RANK", "SLURM_LOCALID"):
        if os.environ.get(key, "") != "":
            return int(os.environ[key])
    return 0


def world_info():
    return {"process_index": rank(), "process_count": world_size(),
            "local_rank": local_rank(),
            "local_device_count": torch.cuda.device_count()}


def is_default_process():
    return rank() == 0


def discover_distributed_env() -> Optional[Tuple[str, int, int]]:
    """(coordinator address 'host:port', number of processes, this
    process's rank) from the launch env, or None for a one-process run:
      * WORLD_SIZE + RANK (+ MASTER_ADDR / MASTER_PORT), the torchrun /
        env:// convention of the reference's sbatch scripts;
      * SLURM_NTASKS + SLURM_PROCID, the coordinator MASTER_ADDR or the
        first host of SLURM_STEP_NODELIST / SLURM_NODELIST.
    The port is MASTER_PORT (default 29500)."""
    port = os.environ.get("MASTER_PORT", "29500")
    world = os.environ.get("WORLD_SIZE", "")
    if world and os.environ.get("RANK", "") != "":
        n = int(world)
        if n <= 1:
            return None
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        return f"{addr}:{port}", n, int(os.environ["RANK"])
    ntasks = os.environ.get("SLURM_NTASKS", "")
    if ntasks and os.environ.get("SLURM_PROCID", "") != "":
        n = int(ntasks)
        if n <= 1:
            return None
        nodelist = os.environ.get(
            "SLURM_STEP_NODELIST", os.environ.get("SLURM_NODELIST", ""))
        addr = os.environ.get("MASTER_ADDR") or _first_host(nodelist)
        return f"{addr}:{port}", n, int(os.environ["SLURM_PROCID"])
    return None


def _first_host(nodelist: str) -> str:
    """The first hostname of a SLURM node list ('a[01-03],b02' -> 'a01')."""
    if not nodelist:
        return "127.0.0.1"
    head = nodelist.split(",")[0]
    if "[" in head:
        prefix, rng = head.split("[", 1)
        first = rng.rstrip("]").split(",")[0].split("-")[0]
        return prefix + first
    return head


def init_distributed(backend, init_method=None, world=None, rank_=None):
    """Joins the process group the launch env asks for (or the one given:
    init_method, world, rank_) over `backend` ('nccl' on the card, 'gloo'
    on the CPU). Returns True if a group was joined, False for a
    one-process run. A launch env that asks for several processes and
    cannot join raises; nothing carries on alone."""
    if init_method is None:
        found = discover_distributed_env()
        if found is None:
            return False
        addr, world, rank_ = found
        init_method = f"tcp://{addr}"
    tdist.init_process_group(backend, init_method=init_method,
                             world_size=world, rank=rank_)
    return True


def process_device(device):
    """The device this process trains on: `device` as given for the CPU,
    else cuda:LOCAL_RANK (made the current device) in a group."""
    device = torch.device(device)
    if device.type == "cuda" and joined():
        device = torch.device("cuda", local_rank())
        torch.cuda.set_device(device)
    return device


def _comm_device():
    """Where a collective's tensors live: the current card under NCCL."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather(obj: Any):
    """Every process's picklable obj, in rank order."""
    if not joined():
        return [obj]
    out = [None] * world_size()
    tdist.all_gather_object(out, obj)
    return out


LOCAL = "local"      # the batch group of a process that reduces nothing


def _group(group):
    """The process group a collective runs over: `group`, every process
    for None; LOCAL when nothing is to be reduced (no group joined, or
    the group is this process alone)."""
    if not joined() or group is LOCAL:
        return LOCAL
    return tdist.group.WORLD if group is None else group


def reduces(group=None):
    """Whether sum_across(x, group) sums over other processes (a group
    joined and `group` not LOCAL)."""
    return _group(group) is not LOCAL


def reduce_dict(d: Dict[str, Any], average=True, group=None):
    """The mean (or with average False the sum) over the processes of
    `group` (default every process) of a dict of scalars (floats or
    one-element tensors), as floats."""
    g = _group(group)
    if g is LOCAL:
        return {k: float(v) for k, v in d.items()}
    keys = sorted(d)
    vec = torch.tensor([float(d[k]) for k in keys], dtype=torch.float64,
                       device=_comm_device())
    tdist.all_reduce(vec, group=g)
    if average:
        vec /= tdist.get_world_size(g)
    return dict(zip(keys, vec.tolist()))


# The collectives below run on _comm_device()'s tensors: the card's under
# NCCL, host copies under gloo (two processes on one card, and the CPU),
# whose CPU collectives are the ones the CPU tests run.

def all_reduce_sum(x, group):
    """The sum of x over `group` (a process group) in a new tensor on x's
    device; a bf16 or fp16 x is summed in fp32 and rounded once."""
    wide = x.dtype in (torch.bfloat16, torch.float16)
    y = x.detach().to(_comm_device(), torch.float32 if wide else x.dtype,
                      copy=True).contiguous()
    tdist.all_reduce(y, group=group)
    return y.to(x.device, x.dtype)


def reduce_scatter_sum(full, group):
    """This process's piece (its 1/size, in rank order) of the sum over
    `group` of every process's flat `full` (its length a multiple of the
    group's size), on full's device."""
    t = full.detach().to(_comm_device()).contiguous()
    out = torch.empty(t.numel() // tdist.get_world_size(group),
                      dtype=t.dtype, device=t.device)
    tdist.reduce_scatter_tensor(out, t, group=group)
    return out.to(full.device)


def all_gather_flat(x, group):
    """Every process of `group`'s flat x, concatenated in rank order, on
    x's device."""
    t = x.detach().to(_comm_device()).contiguous()
    out = torch.empty(t.numel() * tdist.get_world_size(group),
                      dtype=t.dtype, device=t.device)
    tdist.all_gather_into_tensor(out, t, group=group)
    return out.to(x.device)


class _SumAcross(torch.autograd.Function):
    """The sum over a group, whose gradient is the sum of the group's
    gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def sum_across(x, group=None):
    """The sum of x over the processes of `group` (default every
    process), with the gradient of a sum (each process's gradient the sum
    of all of theirs); x itself without one."""
    g = _group(group)
    if g is LOCAL:
        return x
    return _SumAcross.apply(x, g)


def global_count(x, group=None):
    """A count (no gradient) summed over the processes of `group`
    (default every process); x itself without one."""
    g = _group(group)
    if g is LOCAL:
        return x
    return all_reduce_sum(x, g)


def all_gather_tensor(x, group):
    """[every process of `group`'s x] in rank order, on x's device; [x]
    without a group."""
    g = _group(group)
    if g is LOCAL:
        return [x]
    t = x.detach().contiguous().to(_comm_device())
    out = [torch.empty_like(t) for _ in range(tdist.get_world_size(g))]
    tdist.all_gather(out, t, group=g)
    return [o.to(x.device) for o in out]


class _CopyToTP(torch.autograd.Function):
    """Megatron's f: the identity forward, the sum over the tp group
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's g: the sum over the tp group forward, the identity
    backward (its cotangent is the same on every tp rank)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x, group):
    """f in front of a column-parallel layer: x, whose gradient is summed
    over the tp group."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x, group):
    """g behind a row-parallel layer: the sum of the tp ranks' partial
    products, whose gradient passes through."""
    return _ReduceFromTP.apply(x, group)


def wrap_model(model, device):
    """The replicated data-parallel module: model in
    DistributedDataParallel within a group, model itself without one.
    Every parameter is reached by every step, so find_unused_parameters
    stays off; the norms' statistics move the same on every process, so
    buffers are not broadcast. Its step's numbers are those of the
    driver's ZeRO-1 step (parallel/zero.py), which keeps 1/dp of the
    optimizer's state where this one keeps all of it on every process;
    train/trainer.py takes either."""
    if not joined():
        return model
    from torch.nn.parallel import DistributedDataParallel
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False)


def leave():
    """Leaves the process group, if any (its subgroups go with it)."""
    if joined():
        tdist.destroy_process_group()


class NoOp:
    """A sink for the logging of every process but the first."""

    def __getattr__(self, name):
        def noop(*args, **kwargs):
            return None
        return noop
