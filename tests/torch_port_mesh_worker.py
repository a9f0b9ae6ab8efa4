"""One of two gloo processes of tests/test_torch_port_zero1_tp.py.

    python tests/torch_port_mesh_worker.py <tmp dir> <rank>

Reads <tmp>/inputs.pt (written by the test), joins the two-process group
through a rendezvous file in <tmp>, runs every two-process case of the
test and writes what it measured to <tmp>/out<rank>.pt. It imports the
PyTorch package only.
"""
import os
import sys

import torch
import torch.nn as nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from robot3dlotus_tpu_torch.convert import (opt_state_from_jax,  # noqa: E402
                                            opt_state_to_jax, params_to_jax)
from robot3dlotus_tpu_torch.eval.actioner import Actioner  # noqa: E402
from robot3dlotus_tpu_torch.eval.robot_pipeline import \
    MotionPlannerEngine  # noqa: E402
from robot3dlotus_tpu_torch.models.factory import build_model  # noqa: E402
from robot3dlotus_tpu_torch.models.layers import Randomness  # noqa: E402
from robot3dlotus_tpu_torch.models.motion_planner import \
    compute_mp_loss  # noqa: E402
from robot3dlotus_tpu_torch.models.simple_policy import \
    compute_loss  # noqa: E402
from robot3dlotus_tpu_torch.parallel import dist  # noqa: E402
from robot3dlotus_tpu_torch.parallel.mesh import (make_mesh,  # noqa: E402
                                                  shard_model,
                                                  whole_state_dict)
from robot3dlotus_tpu_torch.train.optim import (OPTIMIZERS,  # noqa: E402
                                                build_optimizer)
from robot3dlotus_tpu_torch.train.trainer import Trainer  # noqa: E402

LOSSES = {"policy": compute_loss, "planner": compute_mp_loss}


class Toy(nn.Module):
    """The JAX ZeRO-1 test's toy tree: dense {kernel (16, 8), bias (8,)}
    and odd (3,)."""

    def __init__(self, p):
        super().__init__()
        self.dense = nn.Linear(16, 8)
        self.odd = nn.Parameter(torch.as_tensor(p["odd"]).clone())
        with torch.no_grad():
            self.dense.weight.copy_(torch.as_tensor(p["kernel"]).t())
            self.dense.bias.copy_(torch.as_tensor(p["bias"]))


def params_of(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def toy_cases(inp, mesh, rank):
    """Each case: one update (or `steps`) of the toy from 2x this
    process's partial gradient (the trainer's dp scale), sharded; the
    whole parameters and the whole moments after it."""
    out = {}
    for name, case in inp["toy"]["cases"].items():
        toy = Toy(inp["toy"]["params"])
        opt, _ = build_optimizer(toy, case["cfg"], mesh=mesh,
                                 manual=case["manual"])
        for _ in range(case["steps"]):
            for pname, p in toy.named_parameters():
                p.grad = 2.0 * case["grads"][pname][rank].clone()
            opt.step()
        res = {"params": params_of(toy)}
        if hasattr(opt, "mu"):
            res["mu"] = opt.shard.whole(opt.mu)
            res["nu"] = opt.shard.whole(opt.nu)
            res["shard_n"] = int(opt.mu.numel())
        out[name] = res
    return out


def mean_grads(model):
    """The mean over the two processes of the parameters' gradients, the
    gradient divided by 2 then summed (as DistributedDataParallel and
    the ZeRO-1 reduce-scatter form it)."""
    mean = {k: p.grad / 2 for k, p in model.named_parameters()}
    for g in mean.values():
        torch.distributed.all_reduce(g)
    return mean


def family_step(fam, cfg, mesh, rank):
    """The driver's default ZeRO-1 step on this process's half of the
    batch, the mean gradient it took; each optimizer of the menu on that
    step's gradient, sharded, beside the replicated update of the mean
    gradient; the state written whole at W = 2 and the next step."""
    half = slice(2 * rank, 2 * rank + 2)
    batch = {k: v[half] for k, v in cfg["batch"].items()}
    loss = LOSSES[fam]
    model = build_model(cfg["model"], device="cpu")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt, _ = build_optimizer(model, cfg["train"], mesh=mesh)
    trainer = Trainer(model, lambda p, b, group=None: loss(
        p, b, cfg["act"], cfg["loss"], group=group),
        opt, Randomness(0, perms=cfg["perms"] * 3), mesh=mesh)
    losses = trainer.step(batch)
    after = {k: v.clone() for k, v in model.state_dict().items()}
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    mean = mean_grads(model)
    res = {"losses": {k: float(v) for k, v in losses.items()},
           "params": params_of(model), "grads": mean,
           "shard_n": int(opt.mu.numel()),
           "stats": {k: v.clone() for k, v in after.items()
                     if "running_" in k}, "menu": {}}
    for name in OPTIMIZERS:
        tcfg = dict(cfg["train"], optim=name)
        got = []
        for sharded in (True, False):
            model.load_state_dict(init)
            o, _ = build_optimizer(model, tcfg,
                                   mesh=mesh if sharded else None)
            for k, p in model.named_parameters():
                p.grad = (grads if sharded else mean)[k].clone()
            o.step()
            got.append(params_of(model))
        res["menu"][name] = got
    model.load_state_dict(after)
    # the state at W = 2, written whole by the first process
    state = {"params": params_to_jax(model),
             "opt_state": opt_state_to_jax(opt, model)}
    if rank == 0:
        torch.save(state, os.path.join(TMP, f"{fam}_state.pt"))
    mu = opt.mu.clone()
    opt_state_from_jax(state["opt_state"], opt, model)
    res["reload_exact"] = bool(torch.equal(mu, opt.mu))
    losses = trainer.step(batch)               # the next step at W = 2
    res["next_losses"] = {k: float(v) for k, v in losses.items()}
    res["next_params"] = params_of(model)
    res["next_grads"] = mean_grads(model)
    return res


def manual_step(inp, mesh, rank):
    """TRAIN.zero1_manual's step on this process's half of the batch."""
    cfg = inp["manual"]
    half = slice(2 * rank, 2 * rank + 2)
    batch = {k: v[half] for k, v in cfg["batch"].items()}
    model = build_model(cfg["model"], device="cpu")
    model.load_state_dict(cfg["state"])
    opt, _ = build_optimizer(model, cfg["train"], mesh=mesh, manual=True)
    trainer = Trainer(model, lambda p, b, group=None: compute_loss(
        p, b, cfg["act"], cfg["loss"], group=group),
        opt, Randomness(0), mesh=mesh, manual=True)
    losses = trainer.step(batch)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "params": params_of(model), "grads": mean_grads(model),
            "stats": {k: v.clone() for k, v in model.state_dict().items()
                      if "running_" in k}}


def tp_steps(inp, mesh):
    """One dp x tp step (tp = 2) of each tp case on the whole batch; the
    whole parameters after it and the whole gradient it took."""
    out = {}
    for name, cfg in inp["tp"].items():
        model = build_model(cfg["model"], device="cpu")
        model.load_state_dict(cfg["state"])
        shard_model(model, mesh)
        opt, _ = build_optimizer(model, cfg["train"], mesh=mesh)
        trainer = Trainer(model, lambda p, b, group=None, c=cfg: compute_loss(
            p, b, c["act"], c["loss"], group=group), opt,
            Randomness(cfg["seed"]), mesh=mesh)
        losses = trainer.step(cfg["batch"])
        out[name] = {"losses": {k: float(v) for k, v in losses.items()},
                     "state": whole_state_dict(model),
                     "grads": whole_state_dict(model, {
                         k: p.grad for k, p in model.named_parameters()}),
                     "sharded": sorted(model.tp_plan),
                     "local_shapes": {k: tuple(v.shape) for k, v in
                                      model.state_dict().items()}}
    return out


def serving(inp, rank):
    """Sharded serving under ROBOT3DLOTUS_SERVE_MESH (dp=1,tp=2; predict
    and predict_batch), MotionPlannerEngine(mesh="tp=2"), and
    predict_batch split over dp=2; the plain objects' answers beside
    them."""
    cfg = inp["serve"]
    out = {}
    os.environ["ROBOT3DLOTUS_SERVE_MESH"] = "dp=1,tp=2"
    meshed = Actioner(cfg["policy"], device="cpu")
    del os.environ["ROBOT3DLOTUS_SERVE_MESH"]
    plain = Actioner(cfg["policy"], device="cpu")
    out["tp_sharded"] = sorted(meshed.model.tp_plan)
    for tag, a in (("tp", meshed), ("plain", plain)):
        a.rng = np_rng()
        out[f"{tag}_predict"] = [a.predict(**p)["action"]
                                 for p in cfg["payloads"][:2]]
        a.rng = np_rng()
        out[f"{tag}_batch"] = [o["action"] for o in
                               a.predict_batch(cfg["payloads"])]
    dp = Actioner(cfg["policy"], device="cpu", mesh="dp=2")
    dp.rng = np_rng()
    out["dp_batch"] = [o["action"] for o in dp.predict_batch(
        cfg["payloads"])]
    out["dp_rows"] = dp.mesh.dp_index
    mp = {tag: MotionPlannerEngine(cfg["planner"], device="cpu",
                                   mesh=mesh)
          for tag, mesh in (("tp", "tp=2"), ("plain", None))}
    for tag, engine in mp.items():
        out[f"mp_{tag}"] = engine.predict(**cfg["mp_request"])
    return out


class GroupSum:
    """A stand-in actioner whose every call sums over the group, as a
    sharded model's forward does; dies_at: the call at which this
    process exits (a follower that dies); fails_at: the call that raises
    on this process alone, before its collective."""

    def __init__(self, dies_at=None, fails_at=None):
        self.calls, self.dies_at, self.fails_at = 0, dies_at, fails_at

    def _one(self, payload):
        self.calls += 1
        if self.calls == self.dies_at:
            os._exit(0)
        if self.calls == self.fails_at:
            raise ValueError("this process's call failed")
        t = torch.tensor([float(payload["x"])])
        return {"action": dist.sum_across(t, tdist_world()).numpy()}

    def predict(self, **payload):
        return self._one(payload)

    def predict_batch(self, payloads):
        return [self._one(p) for p in payloads]


def tdist_world():
    return torch.distributed.group.WORLD


def serve(rank, builder, n=3, max_batch=2):
    """consumer_fn over n queries on process 0 (max_batch 2: a
    predict_batch of 2, then a predict), follower_fn on the others."""
    import queue
    from robot3dlotus_tpu_torch.eval.server import consumer_fn, follower_fn
    os.environ.update(ROBOT3DLOTUS_SERVE_MESH="dp=1,tp=2", WORLD_SIZE="2",
                      RANK=str(rank))
    if rank != 0:
        return {"follower_calls": follower_fn(builder)}
    q, answers = queue.Queue(), queue.Queue()
    for i in range(n):
        q.put((0, {"x": i + 1}))
    q.put("STOP")
    consumer_fn(builder, q, [answers], max_batch=max_batch)
    return {"answers": [float(answers.get()["action"][0]) for _ in range(n)]}


def driver_runs(inp):
    """train_simple_policy.main in the two-process group: the driver's
    ZeRO-1 step, then its TRAIN.zero1_manual step, each run to its final
    save."""
    from robot3dlotus_tpu_torch.configs import get_config
    from robot3dlotus_tpu_torch.train import train_simple_policy
    out = {}
    for name, extra in inp["driver"]["runs"].items():
        cfg = get_config(inp["driver"]["config"], inp["driver"]["opts"] +
                         extra + ["output_dir", os.path.join(TMP, name)])
        trainer = train_simple_policy.main(cfg, device="cpu")
        opt = trainer.optimizer
        out[name] = {"manual": trainer.manual, "step": trainer.global_step,
                     "n": opt.n, "total": opt.total,
                     "zero1": opt.shard is not None}
    return out


def np_rng():
    import numpy as np
    return np.random.default_rng(5)


if __name__ == "__main__":
    TMP, RANK = sys.argv[1], int(sys.argv[2])
    torch.set_num_threads(1)
    assert dist.init_distributed("gloo", f"file://{TMP}/rendezvous", 2,
                                 RANK)
    inp = torch.load(os.path.join(TMP, "inputs.pt"), weights_only=False)
    out = {}
    mesh = make_mesh()                               # dp = 2
    out["mesh"] = (mesh.shape, mesh.dp_index, mesh.tp_index)
    out["toy"] = toy_cases(inp, mesh, RANK)
    for fam in ("policy", "planner"):
        out[fam] = family_step(fam, inp["families"][fam], mesh, RANK)
    out["manual"] = manual_step(inp, mesh, RANK)
    out["driver"] = driver_runs(inp)
    tp_mesh = make_mesh(tp=2)                        # dp = 1, tp = 2
    out["tp_mesh"] = (tp_mesh.shape, tp_mesh.dp_index, tp_mesh.tp_index)
    out["tp"] = tp_steps(inp, tp_mesh)
    out["serve"] = serving(inp, RANK)
    # the eval server's followers (the group is left at the stop)
    out["server"] = serve(RANK, GroupSum)
    torch.save(out, os.path.join(TMP, f"out{RANK}.pt"))
    # a follower whose second call raises on it alone, then one that
    # dies at its second call (its process exits): the consumer raises
    import datetime
    import functools
    ends = {}
    for case, kw in (("failed", "fails_at"), ("dead", "dies_at")):
        torch.distributed.init_process_group(
            "gloo", init_method=f"file://{TMP}/rendezvous_{case}",
            world_size=2, rank=RANK,
            timeout=datetime.timedelta(seconds=60))
        try:
            serve(RANK, functools.partial(GroupSum, **{kw: 2 if RANK
                                                       else None}))
            ends[case] = "no error"
        except Exception as e:
            ends[case] = f"{type(e).__name__}: {e}"
        dist.leave()
        torch.save(ends, os.path.join(TMP, f"dead{RANK}.pt"))
    os._exit(0)
