"""Processes training together (port of robot3dlotus_tpu/parallel/dist.py):
rank discovery from the launch environment, the process group, rank
gating, an all_gather of picklable objects, reduce_dict, and the sums
across processes that the data-parallel step takes.

One process a card: torchrun (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) or SLURM (SLURM_NTASKS, SLURM_PROCID, SLURM_LOCALID, the
first host of the node list) says how many processes there are and which
one this is; init_distributed joins them in one torch.distributed group,
NCCL on the card and gloo on the CPU. Without a group every function here
is the one-process case: no collective is called, and sum_across and
global_count return their argument itself.

Under data parallelism (train/driver.py) each process runs the step on
its own shard of the batch: the masked batch norms (models/layers.py
MaskedBatchNorm) take their sums over every process's points with
sum_across, whose gradient is the sum of every process's (JAX's batch
norm under its dp mesh sums over the global batch alike), and the losses
divide by global_count's counts of the whole batch, so that the
processes' losses add up to the loss of the whole batch (the driver's
trainer scales the backward by the world size, which
DistributedDataParallel's mean of the gradients undoes).
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


def reduce_dict(d: Dict[str, Any], average=True):
    """The mean (or with average False the sum) over the processes of a
    dict of scalars (floats or one-element tensors), as floats."""
    if not joined():
        return {k: float(v) for k, v in d.items()}
    keys = sorted(d)
    vec = torch.tensor([float(d[k]) for k in keys], dtype=torch.float64,
                       device=_comm_device())
    tdist.all_reduce(vec)
    if average:
        vec /= world_size()
    return dict(zip(keys, vec.tolist()))


def sum_across(x):
    """The sum of x over every process of the group, with the gradient
    of a sum (each process's gradient the sum of all of theirs); x itself
    without a group."""
    if not joined():
        return x
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x)


def global_count(x):
    """A count (no gradient) summed over every process of the group; x
    itself without a group."""
    if not joined():
        return x
    x = x.detach().clone()
    tdist.all_reduce(x)
    return x


def wrap_model(model, device):
    """The module a data-parallel step runs: model in
    DistributedDataParallel within a group (every parameter is reached
    by every step, so find_unused_parameters stays off; the norms'
    statistics move the same on every process, so buffers are not
    broadcast), model itself without one."""
    if not joined():
        return model
    from torch.nn.parallel import DistributedDataParallel
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False)


def leave():
    """Leaves the process group, if any."""
    if joined():
        tdist.destroy_process_group()


class NoOp:
    """A sink for the logging of every process but the first."""

    def __getattr__(self, name):
        def noop(*args, **kwargs):
            return None
        return noop
