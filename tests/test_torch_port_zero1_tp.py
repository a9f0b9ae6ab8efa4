"""ZeRO-1 and tensor parallelism in the PyTorch port
(robot3dlotus_tpu_torch/parallel/zero.py, parallel/mesh.py, the
tensor-parallel MLP and CPE pairs of models/layers.py, the trainer's mesh
and the sharded Actioner / MotionPlannerEngine), held against the JAX
package's parallel/zero.py and its dp x tp step.

Two gloo processes on the CPU (tests/torch_port_mesh_worker.py, the
process group's rendezvous a file under tmp_path) run every sharded case
while this process runs the JAX references on the conftest's virtual
devices:
  - the ZeRO-1 update of the JAX ZeRO-1 test's toy tree from per-process
    partial gradients against JAX's make_manual_zero1_step on a 2-device
    mesh (tests/test_zero1.py: atol 1e-6), the global-norm clip active
    and inactive, and the moments gathered whole against JAX's; Ralamb
    and RangerLars (per-leaf norms over the shards; RangerLars for six
    updates, through a Lookahead sync) and the fused AdamW under the
    default ZeRO-1 against the one-process update of the summed
    gradient;
  - the driver's default ZeRO-1 step of a tiny policy and a tiny motion
    planner (each process half the batch) against the one-process step
    on the whole batch; every optimizer of the menu, sharded, against the
    replicated update of the same mean gradient (the gradient that
    DistributedDataParallel forms); the W = 2 state, written whole,
    resumed by one process to the W = 2 run's next step;
  - TRAIN.zero1_manual's step against JAX's make_manual_zero1_train_step
    on 2 devices (dropout 0);
  - one dp x tp step (tp = 2) of the tiny AdaNorm policy of
    tests/test_tensor_parallel.py against JAX's make_train_step on
    make_mesh(devices[:2], tp=2), with JAX's bars (losses rtol 2e-4,
    parameters 5e-5), and once more at the release dropout rates, order
    shuffling on, against the port's one-process step with the same
    draws;
  - the Actioner under ROBOT3DLOTUS_SERVE_MESH="dp=1,tp=2" (predict and
    predict_batch), predict_batch split over dp=2 and
    MotionPlannerEngine(mesh="tp=2") against the plain objects, within
    2e-4 (tests/test_sharded_serving.py);
  - the eval server's consumer on process 0 broadcasting each call to a
    follower (eval/server.py), with a stand-in actioner whose calls sum
    over the group; then a follower that dies, on which the consumer
    raises.
Two processes sum a batch's gradient in another order than one, so, as
in tests/test_torch_port_dist.py, the gradients are held at 1e-5 of each
leaf's largest; the parameters after an Adam-like update at 5e-5 where
the gradient is not within rounding of 0 (|g| > 1e-6), since there a
difference in its last bits can flip the update lr g / (|g| + eps).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from robot3dlotus_tpu.models.simple_policy import (SimplePolicyTPU,
                                                   compute_loss as jloss)
from robot3dlotus_tpu.parallel.mesh import make_mesh as jmake_mesh
from robot3dlotus_tpu.parallel.mesh import shard_batch
from robot3dlotus_tpu.parallel.zero import (make_manual_zero1_step,
                                            make_manual_zero1_train_step)
from robot3dlotus_tpu.train.trainer import (create_train_state,
                                            make_train_step)
from robot3dlotus_tpu_torch.convert import (opt_state_from_jax,
                                            params_from_jax)
from robot3dlotus_tpu_torch.eval.synthetic_obs import synthetic_observation
from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.models.layers import Randomness
from robot3dlotus_tpu_torch.models.motion_planner import compute_mp_loss
from robot3dlotus_tpu_torch.models.simple_policy import compute_loss
from robot3dlotus_tpu_torch.train.optim import build_optimizer
from robot3dlotus_tpu_torch.train.trainer import Trainer, batch_to_device
from test_tensor_parallel import TINY_ACT, TINY_PTV3
from test_tensor_parallel import _batch as tp_batch
from test_torch_port_dist import LAUNCH_ENV, _families
from test_torch_port_motion_planner import MP_MODEL
from test_torch_port_policy import MODEL_CFG
from test_torch_port_train_step import RELEASE_CFG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_port_mesh_worker.py")
PARAM_TOL = 5e-5
GRAD_TOL = 1e-5
NEAR_ZERO = 1e-6     # |gradient| within rounding of 0 (eps 1e-8, lr 1e-3)
TOY_CFG = dict(learning_rate=1e-3, lr_sched="cosine", warmup_steps=2,
               num_train_steps=100, weight_decay=0.05, grad_norm=5.0,
               optim="adamw", betas=[0.9, 0.98])
TP_LOSS = dict(pos_weight=1.0, rot_weight=1.0)
TP_TRAIN = dict(learning_rate=1e-4, lr_sched="cosine", warmup_steps=10,
                num_train_steps=100, weight_decay=0.05, grad_norm=10,
                optim="adamw", betas=[0.9, 0.98])
TP_ACT = dict(TINY_ACT, pos_heatmap_type="dist")
TP_MODEL = {"model_class": "SimplePolicyPTV3AdaNorm",
            "ptv3_config": dict(TINY_PTV3), "action_config": TP_ACT}
# the release dropout rates, orders shuffled
TP_DROP_MODEL = dict(TP_MODEL, ptv3_config=dict(
    TINY_PTV3, attn_drop=0.1, proj_drop=0.1, shuffle_orders=True),
    action_config=dict(TP_ACT, dropout=0.2))
MANUAL_MODEL = dict(TP_MODEL, model_class="SimplePolicyPTV3CA")
# the release YAML at tiny width (tests/test_torch_port_train_step.py's),
# two steps and a save each, the loader in series
DRIVER_OPTS = [
    "TRAIN_DATASET.data_dir", "synthetic_reach",
    "TRAIN_DATASET.instr_embed_file", "None",
    "TRAIN_DATASET.taskvar_instr_file", "None",
    "TRAIN_DATASET.taskvar_file", "None", "TRAIN_DATASET.num_points", "256",
    "TRAIN.train_batch_size", "2", "TRAIN.n_workers", "0",
    "TRAIN.num_train_steps", "2", "TRAIN.log_steps", "1",
    "MODEL.ptv3_config.enc_channels", "[16,16,32,32,32]",
    "MODEL.ptv3_config.dec_channels", "[16,16,32,32]",
    "MODEL.ptv3_config.enc_num_head", "[2,2,2,2,2]",
    "MODEL.ptv3_config.dec_num_head", "[2,2,2,2]",
    "MODEL.ptv3_config.enc_patch_size", "[16,16,16,16,16]",
    "MODEL.ptv3_config.dec_patch_size", "[16,16,16,16]",
    "MODEL.ptv3_config.stage_caps", "[256,256,128,64,32]"]
MANUAL_TRAIN = dict(TP_TRAIN, learning_rate=1e-3)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _toy():
    rng = np.random.RandomState(0)
    params = {"kernel": rng.randn(16, 8).astype(np.float32),
              "bias": rng.randn(8).astype(np.float32),
              "odd": rng.randn(3).astype(np.float32)}
    g = np.random.RandomState(1)
    grads = {k: g.randn(2, *v.shape).astype(np.float32)
             for k, v in params.items()}
    small = {k: v * 1e-3 for k, v in grads.items()}
    return params, grads, small


def _torch_grads(grads):
    """The toy's partial gradients by port name (dense.weight transposed)."""
    return {"dense.weight": torch.from_numpy(
        np.ascontiguousarray(grads["kernel"].transpose(0, 2, 1))),
        "dense.bias": torch.from_numpy(grads["bias"]),
        "odd": torch.from_numpy(grads["odd"])}


def _toy_cases():
    params, grads, small = _toy()
    cases = {
        "manual_clip": dict(cfg=TOY_CFG, manual=True, grads=grads),
        "manual_noclip": dict(cfg=dict(TOY_CFG, grad_norm=1e6),
                              manual=True, grads=small),
        "adamw": dict(cfg=TOY_CFG, manual=False, grads=grads),
        "ralamb": dict(cfg=dict(TOY_CFG, optim="ralamb"), manual=False,
                       grads=grads),
        "rangerlars": dict(cfg=dict(TOY_CFG, optim="rangerlars"),
                           manual=False, grads=grads, steps=6)}
    for c in cases.values():
        c["steps"] = c.get("steps", 1)
        c["np_grads"] = c["grads"]
        c["grads"] = _torch_grads(c["grads"])
    return params, cases


def _jax_toy(params, case):
    """JAX's manual ZeRO-1 update of the toy on 2 devices: (params,
    moments) as port-named arrays."""
    mesh = jmake_mesh(jax.devices()[:2], tp=1, sp=1)
    jp = {"dense": {"kernel": jnp.asarray(params["kernel"]),
                    "bias": jnp.asarray(params["bias"])},
          "odd": jnp.asarray(params["odd"])}
    step_fn, opt0 = make_manual_zero1_step(case["cfg"], jp, mesh)
    g = case["np_grads"]
    gs = {"dense": {"kernel": jnp.asarray(g["kernel"]),
                    "bias": jnp.asarray(g["bias"])},
          "odd": jnp.asarray(g["odd"])}
    new_params, new_opt = jax.jit(step_fn)(gs, opt0, jp)
    new_params = _np(new_params)

    def named(tree):
        return {"dense.weight": tree["dense"]["kernel"].T,
                "dense.bias": tree["dense"]["bias"], "odd": tree["odd"]}

    moments = {}
    for leaf in jax.tree_util.tree_leaves(
            new_opt, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            moments = {k: named(_np(getattr(leaf, k))) for k in ("mu", "nu")}
    return named(new_params), moments


def _jax_manual(batch):
    """JAX's make_manual_zero1_train_step on 2 devices: (initial
    variables, new params, new batch stats, losses)."""
    model = SimplePolicyTPU(ptv3_cfg=TINY_PTV3, act_cfg=TINY_ACT,
                            variant="ca")
    mesh = jmake_mesh(jax.devices()[:2], tp=1, sp=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(0)
    state, _ = create_train_state(model, jb, MANUAL_TRAIN, rng, mesh=mesh,
                                  zero1_manual=True)
    init = {"params": _np(state.params),
            "batch_stats": _np(state.batch_stats)}
    step = make_manual_zero1_train_step(
        model, lambda p, b: jloss(p, b, TINY_ACT, TP_LOSS), MANUAL_TRAIN,
        state, mesh)
    state, losses = step(state, shard_batch(jb, mesh), rng)
    return init, _np(state.params), _np(state.batch_stats), \
        {k: float(v) for k, v in losses.items()}


def _jax_tp_init():
    batch = _np(tp_batch(B=4))
    model = SimplePolicyTPU(ptv3_cfg=TINY_PTV3, act_cfg=TINY_ACT,
                            variant="adanorm")
    mesh = jmake_mesh(jax.devices()[:2], tp=2)
    rng = jax.random.PRNGKey(0)
    state, _ = create_train_state(model, batch, TP_TRAIN, rng, mesh=mesh)
    init = {"params": _np(state.params),
            "batch_stats": _np(state.batch_stats)}
    return model, mesh, state, batch, init


def _jax_tp_step(model, mesh, state, batch):
    step = make_train_step(model, lambda p, b: jloss(p, b, TINY_ACT,
                                                     TP_LOSS),
                           mesh=mesh, donate=False)
    state, losses = step(state, shard_batch(batch, mesh),
                         jax.random.PRNGKey(0))
    return _np(state.params), {k: float(v) for k, v in losses.items()}


def _serve_inputs(tmp):
    model = dict(MODEL_CFG, ptv3_config=dict(MODEL_CFG["ptv3_config"],
                                             stage_caps=[128] * 3))
    policy = os.path.join(tmp, "policy.yaml")
    with open(policy, "w") as f:
        yaml.safe_dump({"TRAIN_DATASET": {
            "num_points": 128, "rm_robot": "box_keep_gripper",
            "rm_table": True, "xyz_shift": "center", "use_height": True},
            "MODEL": model}, f)
    planner = os.path.join(tmp, "planner.yaml")
    with open(planner, "w") as f:
        yaml.safe_dump({"MODEL": dict(MP_MODEL, ptv3_config=dict(
            MP_MODEL["ptv3_config"], stage_caps=[256, 256]),
            action_config=dict(MP_MODEL["action_config"],
                               txt_ft_size=512)),
            "TRAIN_DATASET": {"num_points": 256, "xyz_shift": "center",
                              "use_height": True}}, f)
    sizes = [(8, 10), (24, 24), (40, 24), (16, 16)]
    payloads = [{"task_str": "close_jar", "variation": v, "step_id": v,
                 "obs_state_dict": synthetic_observation(
                     30 + v, cameras=1, height=h, width=w)}
                for v, (h, w) in enumerate(sizes)]
    rng = np.random.RandomState(3)
    n = 200
    mp_request = dict(
        pc_ft=rng.uniform(-0.4, 0.4, (n, 4)).astype(np.float32),
        pc_label=rng.randint(0, 4, n).astype(np.int32),
        txt_embed=rng.randn(2, 512).astype(np.float32),
        ee_pose=np.asarray([0.1, -0.2, 0.9, 0, 0, 0, 1, 1], np.float32),
        pc_centroid=np.zeros(3), pc_radius=1.0, table_height=-10.0)
    return {"policy": policy, "planner": planner, "payloads": payloads,
            "mp_request": mp_request}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two workers' outputs beside the references this process
    computes while they run."""
    tmp = tmp_path_factory.mktemp("mesh")
    params, cases = _toy_cases()
    fams = _families()
    manual_batch = _np(tp_batch(B=4, seed=3))
    jmodel, jmesh, jstate, tbatch, tinit = _jax_tp_init()
    tbatch_t = {k: torch.as_tensor(np.array(v)) for k, v in tbatch.items()}
    tp_state = params_from_jax(tinit)
    tp = {"plain": dict(model=TP_MODEL, train=TP_TRAIN, act=TP_ACT,
                        loss=TP_LOSS, seed=0, batch=tbatch_t,
                        state=tp_state),
          "dropout": dict(model=TP_DROP_MODEL, train=TP_TRAIN,
                          act=dict(TP_ACT, dropout=0.2), loss=TP_LOSS,
                          seed=7, batch=tbatch_t, state=tp_state)}
    # the manual step's JAX reference gives its initial variables first
    minit, mparams, mstats, mlosses = _jax_manual(manual_batch)
    inputs = {
        "toy": {"params": params, "cases": {
            k: {kk: vv for kk, vv in c.items() if kk != "np_grads"}
            for k, c in cases.items()}},
        "families": fams,
        "manual": {"model": MANUAL_MODEL, "train": MANUAL_TRAIN,
                   "act": TP_ACT, "loss": TP_LOSS,
                   "state": params_from_jax(minit),
                   "batch": {k: torch.as_tensor(np.array(v))
                             for k, v in manual_batch.items()}},
        "tp": tp, "serve": _serve_inputs(str(tmp)),
        "driver": {"config": RELEASE_CFG, "opts": DRIVER_OPTS, "runs": {
            "zero1": [], "zero1_manual": ["TRAIN.zero1_manual", "True"]}}}
    torch.save(inputs, tmp / "inputs.pt")
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    env.pop("ROBOT3DLOTUS_SERVE_MESH", None)
    # each worker's output to a file: a full pipe would stop it in the
    # middle of a collective while the other is waited on
    logs = [tmp / f"log{r}.txt" for r in range(2)]
    procs = []
    for r in range(2):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(tmp), str(r)], env=env,
                stdout=f, stderr=subprocess.STDOUT))
    try:
        refs = {"toy": {k: _jax_toy(params, c) for k, c in cases.items()
                        if c["manual"]},
                "manual": (mparams, mstats, mlosses),
                "tp": _jax_tp_step(jmodel, jmesh, jstate, tbatch)}
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-4000:]
    outs = [torch.load(tmp / f"out{r}.pt", weights_only=False)
            for r in range(2)]
    return outs, refs, inputs, tmp


def _close(got, want, atol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = want.detach().numpy() if isinstance(want, torch.Tensor) else want
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol,
                               err_msg=what)


def _max(t):
    return float(t.max()) if t.numel() else 0.0


def _same_on_both(outs, key, *path):
    a, b = outs
    for k in path:
        a, b = a[k], b[k]
    for name in a:
        assert torch.equal(a[name], b[name]), f"{key}: {name} differs"


def test_meshes(runs):
    outs, _, _, _ = runs
    for r, out in enumerate(outs):
        assert out["mesh"] == ({"dp": 2, "sp": 1, "tp": 1}, r, 0)
        assert out["tp_mesh"] == ({"dp": 1, "sp": 1, "tp": 2}, 0, r)


@pytest.mark.parametrize("case", ["manual_clip", "manual_noclip"])
def test_zero1_update_equals_jax_manual_step(runs, case):
    """Per-process partial gradients -> the update and the moments of
    JAX's manual ZeRO-1 step (tests/test_zero1.py's atol)."""
    import torch_port_mesh_worker as w
    outs, refs, inputs, _ = runs
    want_p, want_m = refs["toy"][case]
    order = [n for n, _ in w.Toy(inputs["toy"]["params"]).named_parameters()]
    for out in outs:
        got = out["toy"][case]
        for k, v in want_p.items():
            _close(got["params"][k], v, 1e-6, f"{case} {k}")
        for key in ("mu", "nu"):
            flat = np.concatenate([want_m[key][k].reshape(-1)
                                   for k in order])
            _close(got[key], flat, 1e-6, f"{case} {key}")
        # each process holds half the moments
        assert got["shard_n"] == -(-flat.size // 2)


@pytest.mark.parametrize("case", ["adamw", "ralamb", "rangerlars"])
def test_zero1_default_update_equals_one_process(runs, case):
    """The default ZeRO-1's update (per-leaf norms over the shards for
    Ralamb and RangerLars) against the one-process optimizer on the
    summed gradient."""
    outs, _, inputs, _ = runs
    c = inputs["toy"]["cases"][case]
    import torch_port_mesh_worker as w
    toy = w.Toy(inputs["toy"]["params"])
    opt, _ = build_optimizer(toy, c["cfg"])
    for _ in range(c["steps"]):
        for k, p in toy.named_parameters():
            p.grad = c["grads"][k][0] + c["grads"][k][1]
        opt.step()
    for out in outs:
        for k, p in toy.named_parameters():
            _close(out["toy"][case]["params"][k], p, 1e-6, f"{case} {k}")


def _one_process(fam, cfg, steps=1):
    model = build_model(cfg["model"], device="cpu")
    loss = compute_loss if fam == "policy" else compute_mp_loss
    opt, _ = build_optimizer(model, cfg["train"])
    trainer = Trainer(model, lambda p, b: loss(p, b, cfg["act"], cfg["loss"]),
                      opt, Randomness(0, perms=cfg["perms"] * steps))
    losses = trainer.step(batch_to_device(cfg["batch"], "cpu"))
    return model, trainer, {k: float(v) for k, v in losses.items()}


def _grads_close(got, model):
    """The mean gradient of the two processes against the one-process
    gradient, as tests/test_torch_port_dist.py holds them."""
    ref = {k: p.grad for k, p in model.named_parameters()}
    scales = {k: float(g.abs().max()) for k, g in ref.items()}
    gmax = max(scales.values())
    for k, g in ref.items():
        if scales[k] < 1e-6 * gmax:      # zero up to rounding, as here
            assert float(got[k].abs().max()) < 1e-6 * gmax, k
            continue
        _close(got[k], g, GRAD_TOL * max(scales[k], 1e-3 * gmax),
               f"grad {k}")


def _params_close(got, model, grads, tol):
    """Parameters after an Adam-like update, element by element where the
    gradient is not within rounding of 0 (|g| > NEAR_ZERO): there a
    gradient that differs in its last bits moves the update by up to lr
    g / (|g| + eps) of either sign. Those elements still moved by at most
    the lr plus the decay."""
    for k, p in model.named_parameters():
        want, g = p.detach(), grads[k]
        live = g.abs() > NEAR_ZERO
        diff = (got[k] - want).abs()
        assert _max(diff[live]) <= tol, (k, _max(diff[live]))
        assert _max(diff[~live]) <= 2.1e-3, k


@pytest.mark.parametrize("fam", ["policy", "planner"])
def test_zero1_step_equals_one_process_step(runs, fam):
    """The driver's default step at W = 2 (ZeRO-1, half the batch each)
    against the one-process step on the whole batch: the losses, the
    gradient it took, the statistics and the parameters; and the step's
    parameters are the replicated update of that gradient."""
    outs, _, inputs, _ = runs
    model, _, ref = _one_process(fam, inputs["families"][fam])
    for k, v in ref.items():
        if k == "pool_overflow":
            continue
        got = outs[0][fam]["losses"][k] + outs[1][fam]["losses"][k]
        assert abs(got - v) <= 1e-5 * max(1.0, abs(v)), k
    total = sum(p.numel() for p in model.parameters())
    for out in outs:
        _grads_close(out[fam]["grads"], model)
        _params_close(out[fam]["params"], model, out[fam]["grads"],
                      PARAM_TOL)
        zero, replicated = out[fam]["menu"]["adamw"]
        for k, v in out[fam]["params"].items():
            assert torch.equal(v, zero[k]), k
            _close(v, replicated[k], 1e-6 * max(1.0, float(v.abs().max())),
                   k)
        for k, v in model.state_dict().items():
            if "running_" in k:
                _close(out[fam]["stats"][k], v,
                       1e-6 * max(1.0, float(v.abs().max())), k)
        assert out[fam]["shard_n"] == -(-total // 2)
        assert out[fam]["reload_exact"]
    _same_on_both(outs, fam, fam, "params")


@pytest.mark.parametrize("name", ["adamw", "adam", "adamax", "radam",
                                  "ralamb", "rangerlars"])
@pytest.mark.parametrize("fam", ["policy", "planner"])
def test_zero1_menu_equals_replicated_update(runs, fam, name):
    """Each optimizer of the menu, its state sharded, against the
    replicated update of the same mean gradient."""
    outs, _, _, _ = runs
    for out in outs:
        sharded, replicated = out[fam]["menu"][name]
        for k, v in replicated.items():
            _close(sharded[k], v, 1e-6 * max(1.0, float(v.abs().max())),
                   f"{name} {k}")


@pytest.mark.parametrize("fam", ["policy", "planner"])
def test_w2_state_resumes_at_w1(runs, fam):
    """The state written whole at W = 2 loads into one process, whose next
    step on the whole batch is the W = 2 run's next step: its losses, its
    gradient and its parameters."""
    outs, _, inputs, tmp = runs
    cfg = inputs["families"][fam]
    state = torch.load(tmp / f"{fam}_state.pt", weights_only=False)
    model, trainer, _ = _one_process(fam, cfg, steps=2)
    model.load_state_dict(params_from_jax(state["params"]), strict=True)
    opt_state_from_jax(state["opt_state"], trainer.optimizer, model)
    losses = trainer.step(batch_to_device(cfg["batch"], "cpu"))
    for k, v in losses.items():
        if k == "pool_overflow":
            continue
        got = sum(o[fam]["next_losses"][k] for o in outs)
        assert abs(got - float(v)) <= 1e-5 * max(1.0, abs(float(v))), k
    for out in outs:
        _grads_close(out[fam]["next_grads"], model)
        _params_close(out[fam]["next_params"], model,
                      out[fam]["next_grads"], PARAM_TOL)


def test_zero1_manual_step_equals_jax(runs):
    """TRAIN.zero1_manual against JAX's make_manual_zero1_train_step on 2
    devices: the mean of the rank means, each process's own batch-norm
    statistics, averaged after the step."""
    outs, refs, _, _ = runs
    params, stats, losses = refs["manual"]
    want = params_from_jax({"params": params, "batch_stats": stats})
    for out in outs:
        got = out["manual"]
        for k, v in losses.items():
            assert abs(got["losses"][k] - v) <= 1e-4 * max(1.0, abs(v)), k
        for k, v in got["params"].items():
            live = got["grads"][k].abs() > NEAR_ZERO
            tol = 1e-4 * max(1.0, float(want[k].abs().max()))
            assert _max((v - want[k]).abs()[live]) <= tol, k
            assert float((v - want[k]).abs().max()) <= 2.1e-3, k
        for k, v in got["stats"].items():
            _close(v, want[k], 1e-4 * max(1.0, float(want[k].abs().max())),
                   k)
    _same_on_both(outs, "manual", "manual", "params")


def _tp_one_process(cfg):
    """The one-process step of a tp case: its model, gradient taken."""
    model = build_model(cfg["model"], device="cpu")
    model.load_state_dict(cfg["state"])
    opt, _ = build_optimizer(model, cfg["train"])
    trainer = Trainer(model, lambda p, b: compute_loss(
        p, b, cfg["act"], cfg["loss"]), opt, Randomness(cfg["seed"]))
    losses = trainer.step(cfg["batch"])
    return model, losses


def test_tp_step_equals_jax_dp_tp_step(runs):
    """One dp x tp step at tp = 2 against JAX's on make_mesh(devices[:2],
    tp=2): JAX's bars (tests/test_tensor_parallel.py); the gradient it
    took, gathered whole, against the one-process gradient as
    tests/test_torch_port_dist.py holds them (the backward of Megatron's
    f and g: at the first step's warmup lr the parameters cannot tell a
    wrong gradient, and Adam's first step hardly sees its scale)."""
    outs, refs, inputs, _ = runs
    jparams, jlosses = refs["tp"]
    want = params_from_jax({"params": jparams})
    model, _ = _tp_one_process(inputs["tp"]["plain"])
    for out in outs:
        got = out["tp"]["plain"]
        for k, v in jlosses.items():
            np.testing.assert_allclose(got["losses"][k], v, rtol=2e-4,
                                       err_msg=k)
        worst = max(float((got["state"][k] - v).abs().max())
                    for k, v in want.items())
        assert worst < 5e-5, worst
        _grads_close(got["grads"], model)
        # the pairs sharded: each column / row leaf at half its width
        assert len(got["sharded"]) >= 8
        whole = inputs["tp"]["plain"]["state"]
        for k in got["sharded"]:
            assert np.prod(got["local_shapes"][k]) * 2 == whole[k].numel()
    assert outs[0]["tp"]["plain"]["sharded"] == \
        outs[1]["tp"]["plain"]["sharded"]


def test_tp_dropout_step_equals_one_process(runs):
    """The release dropout rates and shuffled orders: the tp = 2 step
    draws what one process draws (the hidden's mask at its whole width),
    so it gives the one-process step: its losses, its gradient and its
    parameters."""
    outs, _, inputs, _ = runs
    model, losses = _tp_one_process(inputs["tp"]["dropout"])
    for out in outs:
        got = out["tp"]["dropout"]
        for k, v in losses.items():
            np.testing.assert_allclose(got["losses"][k], float(v),
                                       rtol=2e-4, err_msg=k)
        sd = model.state_dict()
        worst = max(float((got["state"][k] - sd[k]).abs().max())
                    for k in sd)
        assert worst < 5e-5, worst
        _grads_close(got["grads"], model)


def test_sharded_serving_equals_plain(runs):
    """The Actioner under ROBOT3DLOTUS_SERVE_MESH="dp=1,tp=2" (predict at
    B = 1, predict_batch), predict_batch split over dp = 2, and the
    motion planner under mesh="tp=2", against the plain objects on every
    process (tests/test_sharded_serving.py's 2e-4)."""
    outs, _, _, _ = runs
    for out in outs:
        s = out["serve"]
        assert len(s["tp_sharded"]) >= 8
        for tag in ("tp_predict", "tp_batch", "dp_batch"):
            ref = s["plain_batch" if "batch" in tag else "plain_predict"]
            assert len(s[tag]) == len(ref)
            for got, want in zip(s[tag], ref):
                np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4,
                                           err_msg=tag)
        np.testing.assert_allclose(s["mp_tp"], s["mp_plain"], atol=2e-4,
                                   rtol=2e-4)
    assert [o["serve"]["dp_rows"] for o in outs] == [0, 1]


def test_eval_server_followers(runs):
    """The consumer's calls (a predict_batch of 2, then a predict) made
    on the follower too, in order, until the stop; a follower that dies
    makes the consumer raise; a call that raises on the follower alone
    ends the follower with its error and makes the consumer raise."""
    outs, _, _, tmp = runs
    # each answer sums the query's x over the two processes
    assert outs[0]["server"] == {"answers": [2.0, 4.0, 6.0]}
    assert outs[1]["server"] == {"follower_calls": 2}
    consumer, follower = (torch.load(tmp / f"dead{r}.pt", weights_only=False)
                          for r in range(2))
    assert consumer["dead"] != "no error", consumer
    assert consumer["failed"] != "no error", consumer
    assert follower["failed"] == \
        "ValueError: this process's call failed", follower


@pytest.mark.parametrize("name", ["zero1", "zero1_manual"])
def test_driver_zero1_runs_and_resumes_at_w1(runs, name):
    """train_simple_policy.main at W = 2: the ZeRO-1 step (half the state
    a process), or the manual one, to its final save; the files hold the
    whole state, and the ZeRO-1 run's resume in one process (the
    driver's own resume) goes on to its next step."""
    outs, _, inputs, tmp = runs
    for out in outs:
        got = out["driver"][name]
        assert got["step"] == 2 and got["zero1"]
        assert got["manual"] == (name == "zero1_manual")
        assert got["n"] == -(-got["total"] // 2)
    from robot3dlotus_tpu_torch.configs import get_config
    from robot3dlotus_tpu_torch.train import train_simple_policy
    from robot3dlotus_tpu_torch.train.checkpoint import (
        load_train_state_latest, resume_or_init)
    from robot3dlotus_tpu_torch.train.driver import build_trainer
    run_dir = tmp / name
    latest = load_train_state_latest(str(run_dir))
    assert int(latest["step"]) == 2
    if name == "zero1_manual":
        # the optax chain's per-leaf state, no clip link (JAX's
        # create_train_state(zero1_manual=True)); it resumes in a group
        core = latest["opt_state"]["0"]["0"]
        assert int(core["count"]) == 2 and "mu" in core
        return
    cfg = get_config(RELEASE_CFG, DRIVER_OPTS + ["TRAIN.num_train_steps",
                                                 "3"])
    trainer, batches, _ = build_trainer(cfg, train_simple_policy.SPEC,
                                        device="cpu")
    assert resume_or_init(trainer, str(run_dir)) == 2
    assert trainer.optimizer.count == 2
    losses = trainer.step(batch_to_device(next(batches), "cpu"))
    assert all(np.isfinite(float(v)) for v in losses.values())
