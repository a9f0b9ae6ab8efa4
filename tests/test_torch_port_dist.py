"""Data parallelism across processes in the PyTorch port
(robot3dlotus_tpu_torch/parallel/dist.py, the synced MaskedBatchNorm, the
losses' global counts, the trainer under DistributedDataParallel).

Rank discovery mirrors tests/test_multihost.py. Then two gloo processes on
the CPU (the process group rendezvous through a file under tmp_path, so
that files running side by side never share a port) each run, on their
half of a batch:
  - all_gather of Python objects and reduce_dict (mean and sum);
  - a masked batch norm in train mode: its output and input gradient
    (the cotangent's share on each process) and its running statistics
    against one process on the whole batch;
  - one step of a tiny policy and one of a tiny motion planner (dropout
    0, the same order permutations injected), with two valid clouds on
    one process and one on the other (and the planner's unequal
    trajectory steps), through the driver's trainer in
    DistributedDataParallel; a second step follows (every parameter must
    be reached, or DistributedDataParallel raises).
The one-process steps on the whole batch are the ones that
test_torch_port_train_step.py and test_torch_port_mp_train.py hold
against the JAX make_train_step. Gradients (the first step's, averaged
by DistributedDataParallel) within 1e-5 of each leaf's largest |grad|
(fp32 sums split over two processes), floored as the one-process tests
floor theirs at 1e-3 of the largest |grad| of all leaves (a leaf whose
gradient nearly cancels, as a norm's bias after a conv, carries the
rounding of the larger ones); a leaf whose gradient is zero up to
rounding there (below 1e-6 of the largest: a bias in front of a batch
norm) must be so in both processes too; batch-norm statistics within 1e-6 of
max(1, |ref|); gradients, not updated parameters, are compared:
Adam's first step is about lr sign(g) and flips on a gradient near 0.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.models.layers import MaskedBatchNorm, Randomness
from robot3dlotus_tpu_torch.models.motion_planner import compute_mp_loss
from robot3dlotus_tpu_torch.models.simple_policy import compute_loss
from robot3dlotus_tpu_torch.parallel import dist
from robot3dlotus_tpu_torch.parallel.dist import (_first_host,
                                                  discover_distributed_env)
from robot3dlotus_tpu_torch.train.optim import build_optimizer
from robot3dlotus_tpu_torch.train.trainer import Trainer, batch_to_device
from test_torch_port_motion_planner import ACT as MP_ACT
from test_torch_port_motion_planner import MP_MODEL, mp_batch
from test_torch_port_train_step import ACT, LOSS, PERMS, PTV3, TRAIN, _batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = 1e-5
STAT_TOL = 1e-6
POLICY = {"model_class": "SimplePolicyPTV3CA", "ptv3_config": PTV3,
          "action_config": ACT}
MP_PERMS = [[3, 1, 0, 2], [1, 2, 3, 0]]
LAUNCH_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID",
              "SLURM_NODELIST", "SLURM_STEP_NODELIST")


# ---- rank discovery (tests/test_multihost.py) ----

def test_env_discovery_explicit(monkeypatch):
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    assert discover_distributed_env() is None
    assert dist.init_distributed("gloo") is False and not dist.joined()
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "12345")
    assert discover_distributed_env() == ("10.0.0.1:12345", 4, 3)
    assert dist.local_rank() == 1
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert discover_distributed_env() is None


def test_env_discovery_slurm(monkeypatch):
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SLURM_NTASKS", "8")
    monkeypatch.setenv("SLURM_PROCID", "5")
    monkeypatch.setenv("SLURM_LOCALID", "2")
    monkeypatch.setenv("SLURM_NODELIST", "node[03-04],node07")
    monkeypatch.setenv("MASTER_PORT", "29501")
    assert discover_distributed_env() == ("node03:29501", 8, 5)
    assert dist.local_rank() == 2


def test_first_host():
    assert _first_host("") == "127.0.0.1"
    assert _first_host("gpu01") == "gpu01"
    assert _first_host("gpu[11-14]") == "gpu11"
    assert _first_host("a[2,5-7],b1") == "a2"


def test_one_process_calls_no_collective():
    """Without a group every helper is the one-process case."""
    assert not dist.joined()
    assert (dist.rank(), dist.world_size()) == (0, 1)
    x = torch.arange(3.0)
    assert dist.sum_across(x) is x and dist.global_count(x) is x
    assert dist.all_gather({"a": 1}) == [{"a": 1}]
    assert dist.reduce_dict({"a": torch.tensor(2.0)}) == {"a": 2.0}
    model = torch.nn.Linear(2, 2)
    assert dist.wrap_model(model, torch.device("cpu")) is model


# ---- two gloo processes ----

WORKER = textwrap.dedent("""
    import sys
    import torch
    sys.path.insert(0, sys.argv[1])
    from robot3dlotus_tpu_torch.models.factory import build_model
    from robot3dlotus_tpu_torch.models.layers import (MaskedBatchNorm,
                                                      Randomness)
    from robot3dlotus_tpu_torch.models.motion_planner import compute_mp_loss
    from robot3dlotus_tpu_torch.models.simple_policy import compute_loss
    from robot3dlotus_tpu_torch.parallel import dist
    from robot3dlotus_tpu_torch.train.optim import build_optimizer
    from robot3dlotus_tpu_torch.train.trainer import Trainer

    tmp, rank = sys.argv[2], int(sys.argv[3])
    torch.set_num_threads(1)
    assert dist.init_distributed("gloo", f"file://{tmp}/rendezvous", 2,
                                 rank)
    inp = torch.load(f"{tmp}/inputs.pt", weights_only=False)
    out = {"info": dist.world_info(),
           "gathered": dist.all_gather({"rank": rank, "items": [rank] * 3}),
           "mean": dist.reduce_dict({"x": rank + 1.0, "y": 2.0}),
           "sum": dist.reduce_dict({"x": torch.tensor(rank + 1.0)},
                                   average=False)}
    bn = MaskedBatchNorm(inp["bn_x"].shape[-1]).train()
    bn.load_state_dict(inp["bn_state"])
    half = slice(2 * rank, 2 * rank + 2)
    x = inp["bn_x"][half].clone().requires_grad_()
    y = bn(x, inp["bn_mask"][half])
    (y * inp["bn_g"][half]).sum().backward()
    out["bn"] = {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad,
                 "db": bn.bias.grad,
                 "stats": {k: v.clone() for k, v in bn.state_dict().items()
                           if k.startswith("running")}}
    for fam, loss in (("policy", compute_loss), ("planner", compute_mp_loss)):
        cfg = inp[fam]
        model = build_model(cfg["model"], device="cpu")
        opt, _ = build_optimizer(model, cfg["train"])
        trainer = Trainer(
            model, lambda p, b, f=loss, c=cfg: f(p, b, c["act"], c["loss"]),
            opt, Randomness(0, perms=cfg["perms"] * 2),   # two steps
            net=dist.wrap_model(model, torch.device("cpu")))
        batch = {k: v[half] for k, v in cfg["batch"].items()}
        losses = trainer.step(batch)
        out[fam] = {
            "losses": {k: float(v) for k, v in losses.items()},
            "grads": {k: p.grad.clone() for k, p in
                      model.named_parameters()},
            "stats": {k: v.clone() for k, v in model.state_dict().items()
                      if "running_" in k}}
        trainer.step(batch)          # every parameter reached again
    torch.save(out, f"{tmp}/out{rank}.pt")
    dist.leave()
""")


def _stack(a, b, valid_b):
    """The batch of a's clouds then b's, b's batch_valid set to valid_b."""
    b = dict(b, batch_valid=np.asarray(valid_b, bool))
    return {k: torch.as_tensor(np.concatenate([a[k], b[k]])) for k in a}


def _bn_inputs():
    rng = np.random.RandomState(7)
    B, N, C = 4, 50, 6
    x = torch.from_numpy((rng.randn(B, N, C) * 2 + 1).astype(np.float32))
    mask = torch.from_numpy(rng.rand(B, N) < [[0.9], [0.6], [0.3], [0.8]])
    g = torch.from_numpy(rng.randn(B, N, C).astype(np.float32))
    bn = MaskedBatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 2, C)))
        bn.bias.copy_(torch.from_numpy(rng.randn(C)))
        bn.running_mean.copy_(torch.from_numpy(rng.randn(C)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, C)))
    return x, mask, g, bn.state_dict()


def _families():
    # two valid clouds on the first process, one on the second
    return {
        "policy": {"model": POLICY, "train": TRAIN, "act": ACT,
                   "loss": LOSS, "perms": PERMS,
                   "batch": _stack(_batch(0), _batch(5), [True, False])},
        "planner": {"model": MP_MODEL, "train": TRAIN, "act": MP_ACT,
                    "loss": LOSS, "perms": MP_PERMS,
                    "batch": _stack(mp_batch(3), mp_batch(4),
                                    [True, False])}}


def _reference(fam, cfg):
    """One process on the whole batch: grads, stats, losses."""
    model = build_model(cfg["model"], device="cpu")
    opt, _ = build_optimizer(model, cfg["train"])
    loss = compute_loss if fam == "policy" else compute_mp_loss
    trainer = Trainer(model, lambda p, b: loss(p, b, cfg["act"], cfg["loss"]),
                      opt, Randomness(0, perms=cfg["perms"]))
    losses = trainer.step(batch_to_device(cfg["batch"], "cpu"))
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": {k: p.grad for k, p in model.named_parameters()},
            "stats": {k: v for k, v in model.state_dict().items()
                      if "running_" in k}}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    x, mask, g, state = _bn_inputs()
    fams = _families()
    torch.save({"bn_x": x, "bn_mask": mask, "bn_g": g, "bn_state": state,
                **fams}, tmp / "inputs.pt")
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, ROOT, str(tmp),
                               str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return ([torch.load(tmp / f"out{r}.pt", weights_only=False)
             for r in range(2)], (x, mask, g, state), fams)


def test_all_gather_and_reduce_dict(two_ranks):
    outs, _, _ = two_ranks
    for r, out in enumerate(outs):
        assert out["info"]["process_index"] == r
        assert out["info"]["process_count"] == 2
        assert out["gathered"] == [{"rank": i, "items": [i] * 3}
                                   for i in range(2)]
        assert out["mean"] == {"x": 1.5, "y": 2.0}
        assert out["sum"] == {"x": 3.0}


def test_masked_batch_norm_over_both_processes(two_ranks):
    outs, (x, mask, g, state), _ = two_ranks
    bn = MaskedBatchNorm(x.shape[-1]).train()
    bn.load_state_dict(state)
    xr = x.clone().requires_grad_()
    y = bn(xr, mask)
    (y * g).sum().backward()
    for r, out in enumerate(outs):
        got = out["bn"]
        np.testing.assert_allclose(got["y"], y.detach()[2 * r:2 * r + 2],
                                   rtol=0, atol=STAT_TOL * float(
                                       y.detach().abs().max()))
        np.testing.assert_allclose(got["dx"], xr.grad[2 * r:2 * r + 2],
                                   rtol=0, atol=GRAD_TOL * float(
                                       xr.grad.abs().max()))
        for k, v in got["stats"].items():
            np.testing.assert_allclose(v, bn.state_dict()[k], rtol=0,
                                       atol=STAT_TOL * max(
                                           1.0, float(v.abs().max())))
    # the parameters' gradients: each process's share, summed
    for name, ref in (("dw", bn.weight.grad), ("db", bn.bias.grad)):
        got = outs[0]["bn"][name] + outs[1]["bn"][name]
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=GRAD_TOL * float(ref.abs().max()))


@pytest.mark.parametrize("fam", ["policy", "planner"])
def test_dp_step_equals_one_process_step(two_ranks, fam):
    outs, _, fams = two_ranks
    ref = _reference(fam, fams[fam])
    for k, v in ref["losses"].items():
        if k == "pool_overflow":
            continue
        got = outs[0][fam]["losses"][k] + outs[1][fam]["losses"][k]
        assert abs(got - v) <= 1e-5 * max(1.0, abs(v)), k
    scales = {k: float(g.abs().max()) for k, g in ref["grads"].items()}
    gmax = max(scales.values())
    floor = 1e-3 * gmax
    for out in outs:
        assert set(out[fam]["grads"]) == set(ref["grads"])
        for k, g in ref["grads"].items():
            if scales[k] < 1e-6 * gmax:     # zero up to rounding, as here
                assert float(out[fam]["grads"][k].abs().max()) < \
                    1e-6 * gmax, k
                continue
            np.testing.assert_allclose(
                out[fam]["grads"][k], g, rtol=0,
                atol=GRAD_TOL * max(scales[k], floor), err_msg=f"grad {k}")
        assert set(out[fam]["stats"]) == set(ref["stats"]) != set()
        for k, v in ref["stats"].items():
            np.testing.assert_allclose(
                out[fam]["stats"][k], v, rtol=0,
                atol=STAT_TOL * max(1.0, float(v.abs().max())), err_msg=k)
    # DistributedDataParallel leaves the same averaged gradient everywhere
    for k in ref["grads"]:
        assert torch.equal(outs[0][fam]["grads"][k], outs[1][fam]["grads"][k])
