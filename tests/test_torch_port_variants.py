"""PyTorch port vs the JAX package: the conditioning variants, the context
tokens and the head types of the keystep policy.

At a small size (2 stages, widths <= 32, 128 points) on the CPU, the JAX
side on its exact XLA paths:
  * the eval forward of SimplePolicyPTV3AdaNorm / CA / Concat for every
    txt_reduce (mean, attn; the CA variant reads none), pdnorm_only_decoder
    True / False and the pose and step tokens on / off: seeded weights of
    the port, perturbed, carried to the JAX tree by params_to_jax, whose
    structure and shapes must equal the JAX init's (jax.eval_shape) and
    which params_from_jax inverts bit for bit; the logits within
    1e-4 * max(1, |ref|) and the decoded actions within 1e-4;
  * each head type (heatmap_mlp; reduce mean / attn; quat, rot6d, euler,
    euler_delta): outputs, compute_loss and decode_actions; the port raises
    where the JAX head raises;
  * the ens1 decode bit-equal to the JAX one (the chosen voxels), and
    deterministic;
  * an Actioner with num_ensembles = 3, best_disc_pos 'ens1' and the pose
    and step tokens against the JAX Actioner, each member's order
    permutations injected on both sides (jax.random.permutation patched,
    the JAX forwards run unjitted so that every member draws its own);
    the pose and step reaching the model on the host and the fused paths;
  * one whole train step of SimplePolicyPTV3AdaNorm (txt_reduce attn, pose
    and step tokens) against the JAX make_train_step;
  * the datasets' rot_type targets (quat, euler, euler_delta, rot6d) and
    the continuous pos_type, loader batches bit-equal to the JAX loader's;
  * model files of each new class: the JAX .msgpack and the upstream-layout
    .pt (the JAX save_torch_checkpoint) loaded by the port, bit-equal.
The motion planner's variants: test_torch_port_variants_mp.py; the Concat
stem's kernels: test_torch_port_wide_stem.py.
"""
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import yaml

from robot3dlotus_tpu.eval.actioner import Actioner as JaxActioner
from robot3dlotus_tpu.models.heads import ActionHead as JaxActionHead
from robot3dlotus_tpu.models.simple_policy import (
    SimplePolicyTPU, compute_loss as jloss, decode_actions as jdecode)
from robot3dlotus_tpu.ops import pos_codec as jpos
from robot3dlotus_tpu.train import checkpoint as jckpt
from robot3dlotus_tpu.train import torch_convert as jtc
from robot3dlotus_tpu.train.datasets import loader as jloader
from robot3dlotus_tpu.train.datasets.keystep_dataset import \
    KeystepDataset as JKeystepDataset
from robot3dlotus_tpu.train.datasets.motion_dataset import \
    MotionPlannerDataset as JMotionDataset
from robot3dlotus_tpu.train.datasets.motion_dataset import \
    collate_motion_samples as jcollate_motion
from robot3dlotus_tpu.train.datasets import store as jstore
from robot3dlotus_tpu.train.optim import build_optimizer as jbuild_optimizer
from robot3dlotus_tpu.train.trainer import TrainState, make_train_step
from robot3dlotus_tpu_torch.convert import params_from_jax, params_to_jax
from robot3dlotus_tpu_torch.eval.actioner import Actioner
from robot3dlotus_tpu_torch.eval.synthetic_obs import synthetic_observation
from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.models.heads import ActionHead
from robot3dlotus_tpu_torch.models.layers import Randomness
from robot3dlotus_tpu_torch.models.simple_policy import (compute_loss,
                                                         decode_actions)
from robot3dlotus_tpu_torch.ops.pos_codec import best_pos_from_disc_logits
from robot3dlotus_tpu_torch.train import checkpoint as ckpt
from robot3dlotus_tpu_torch.train.datasets import loader, store
from robot3dlotus_tpu_torch.train.datasets.keystep_dataset import \
    KeystepDataset
from robot3dlotus_tpu_torch.train.datasets.motion_dataset import (
    MotionPlannerDataset, collate_motion_samples)
from robot3dlotus_tpu_torch.train.optim import build_optimizer
from robot3dlotus_tpu_torch.train.trainer import Trainer, batch_to_device
from test_torch_port_train_step import (ACT, LOSS, PTV3, TRAIN, _batch,
                                        _perturb)

ATOL = 1e-4
POLICY = {"SimplePolicyPTV3AdaNorm": "adanorm", "SimplePolicyPTV3CA": "ca",
          "SimplePolicyPTV3Concat": "concat"}
JAX_IMPL = {"attn_impl": "xla", "conv_impl": "xla"}
MAX_STEPS = 8


def T(a):
    return torch.from_numpy(np.array(a))


def ee_poses(rng, B):
    """(B, 8) gripper poses: position, a unit xyzw quaternion, open."""
    q = rng.randn(B, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([rng.uniform(-0.1, 0.1, (B, 3)), q,
                           rng.randint(0, 2, (B, 1))], 1).astype(np.float32)


def policy_batch(seed=0, gt=None):
    batch = _batch(seed)
    rng = np.random.RandomState(seed + 100)
    batch["ee_poses"] = ee_poses(rng, 2)
    batch["step_ids"] = np.array([1, MAX_STEPS - 1], np.int32)
    if gt is not None:
        batch["gt_actions"] = gt
    return batch


def perturb_port(model, seed=1):
    """Seeded noise on every parameter and running mean, the running
    variances scaled, so that every leaf moves the output."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in sorted(model.state_dict().items()):
            if name.endswith("running_var"):
                t.mul_(T(rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))
            else:
                t.add_(T((rng.randn(*t.shape) * 0.1).astype(np.float32)))
    return model


def shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


def carried(port_cfg, jmodel, jb):
    """The perturbed seeded port model and its variables as a JAX tree,
    which must have the JAX init's structure and shapes and come back
    through params_from_jax bit for bit."""
    port = perturb_port(build_model(port_cfg, device="cpu", seed=3))
    variables = params_to_jax(port)
    key = jax.random.PRNGKey(0)
    want = jax.eval_shape(lambda b: jmodel.init(
        {"params": key, "dropout": key, "shuffle": key}, b,
        deterministic=True), jb)
    assert shapes(variables) == shapes(
        {"params": want["params"], "batch_stats": want["batch_stats"]})
    back = params_from_jax(variables)
    sd = port.state_dict()
    assert set(back) == set(sd)
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    return port, variables


def close(got, want, name, tol=ATOL):
    """Within tol * max(1, |ref|) over the entries the model does not mask
    (masked position logits hold -1e9 on both sides)."""
    want = np.asarray(want)
    got = got.detach().numpy()
    live = want > -1e8
    np.testing.assert_array_equal(got <= -1e8, ~live, err_msg=name)
    scale = max(1.0, float(np.abs(want[live]).max()))
    np.testing.assert_allclose(got[live], want[live], atol=tol * scale,
                               rtol=0, err_msg=name)


def model_cfg(cls, ptv3=None, act=None):
    return {"model_class": cls, "ptv3_config": dict(PTV3, **(ptv3 or {})),
            "action_config": dict(ACT, max_steps=MAX_STEPS, **(act or {}))}


def jax_policy(cfg):
    return SimplePolicyTPU(ptv3_cfg=dict(cfg["ptv3_config"], **JAX_IMPL),
                           act_cfg=cfg["action_config"],
                           variant=POLICY[cfg["model_class"]])


def check_policy(cfg, batch, keys=("pos", "rot", "open")):
    """The eval forward, the loss and the decode of the port against the
    JAX package on one batch; returns the port model."""
    jmodel, act = jax_policy(cfg), cfg["action_config"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    port, variables = carried(cfg, jmodel, jb)

    @jax.jit
    def run(v, b):
        p = jmodel.apply(v, b, deterministic=True)
        return ({k: p[k] for k in keys}, jloss(p, b, act, LOSS),
                jdecode(p, act))
    preds, losses, actions = run(variables, jb)
    with torch.no_grad():
        got = port(batch_to_device(batch, "cpu"))
        got_losses = compute_loss(got, batch_to_device(batch, "cpu"), act,
                                  LOSS)
        got_actions = decode_actions(got, act)
    for k in keys:
        close(got[k], preds[k], k)
    for k in losses:
        close(got_losses[k], losses[k], f"loss {k}")
    np.testing.assert_allclose(got_actions.numpy(), np.asarray(actions),
                               atol=ATOL, rtol=0)
    return port


# ---------------------------------------------------------- forwards --

FORWARD_CASES = [
    (cls, reduce, only_dec, tokens)
    for cls in POLICY for reduce in ("mean", "attn")
    for only_dec in (False, True) for tokens in (False, True)
    if not (cls == "SimplePolicyPTV3CA" and reduce == "attn")]


@pytest.mark.parametrize("cls,reduce,only_dec,tokens", FORWARD_CASES)
def test_policy_variant_forward_matches_jax(cls, reduce, only_dec, tokens):
    cfg = model_cfg(cls, {"pdnorm_only_decoder": only_dec,
                          "pdnorm_adaptive": True},
                    {"txt_reduce": reduce, "use_ee_pose": tokens,
                     "use_step_id": tokens})
    port = check_policy(cfg, policy_batch())
    names = {k for k, _ in port.named_parameters()}
    assert ("pose_embedding.rot_embedding.weight" in names) == tokens
    assert ("stepid_embedding.weight" in names) == tokens
    assert ("txt_attn_fc.weight" in names) == (
        reduce == "attn" and cls != "SimplePolicyPTV3CA")
    adaptive = {n.split(".modulation")[0] for n in names
                if ".modulation." in n}
    if cls != "SimplePolicyPTV3AdaNorm":
        assert not adaptive
    elif only_dec:
        # the stem, the encoder's pooling and its first stage's blocks
        # are plain; the last stage and the decoder adaptive
        assert "ptv3_model.embedding_norm" not in adaptive
        assert "ptv3_model.enc1_down.norm" not in adaptive
        assert "ptv3_model.enc0_block0.norm1" not in adaptive
        assert "ptv3_model.enc1_block0.norm1" in adaptive
        assert "ptv3_model.dec0_up.proj_norm" in adaptive
    else:
        assert "ptv3_model.embedding_norm" in adaptive
    if cls == "SimplePolicyPTV3Concat":
        assert port.ptv3_model.embedding_stem_conv.weight.shape[1] == \
            7 + ACT["context_channels"]
    cablocks = {n.split(".")[1] for n in names if "_cablock" in n}
    if cls == "SimplePolicyPTV3CA":
        assert cablocks == ({"enc1_cablock0", "dec0_cablock0"} if only_dec
                            else {"enc0_cablock0", "enc1_cablock0",
                                  "dec0_cablock0"})
    else:
        assert not cablocks


def test_unconditioned_adanorm_matches_jax():
    """pdnorm_adaptive False (the YAML's value): the AdaNorm class with
    plain norms, its context computed and unused, as in the JAX package."""
    cfg = model_cfg("SimplePolicyPTV3AdaNorm", {"pdnorm_adaptive": False})
    port = check_policy(cfg, policy_batch(seed=4))
    assert not any(".modulation." in n for n, _ in port.named_parameters())


# -------------------------------------------------------------- heads --

HEAD_CASES = [("heatmap_mlp", "max", "quat", 8),
              ("heatmap_mlp", "mean", "rot6d", 10),
              ("heatmap_disc", "attn", "euler", 7),
              ("heatmap_mlp", "attn", "euler_delta", 7),
              ("heatmap_disc", "mean", "euler_disc", 7)]


def _gt(rng, rot_type, B=2, pos=None):
    """(B, 3 + R + 1) targets of a rot_type: bins, a unit quaternion,
    angles / 180, deltas, or the first two matrix columns."""
    if rot_type == "euler_disc":
        rot = rng.randint(0, 72, (B, 3)).astype(np.float32)
    elif rot_type == "quat":
        rot = rng.randn(B, 4)
        rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    elif rot_type == "rot6d":
        rot = rng.randn(B, 6)
    else:
        rot = rng.uniform(-1, 1, (B, 3))
    pos = rng.uniform(-0.05, 0.05, (B, 3)) if pos is None else pos
    return np.concatenate([pos, rot, rng.randint(0, 2, (B, 1))],
                          1).astype(np.float32)


@pytest.mark.parametrize("pos_type,reduce,rot_type,dim", HEAD_CASES)
def test_head_types_match_jax(pos_type, reduce, rot_type, dim):
    """Each head type on the CA policy: outputs, loss (the euler loss's
    wrapped twin included: targets near +-1) and decode."""
    rng = np.random.RandomState(dim)
    base = policy_batch(seed=5)
    gt = _gt(rng, rot_type, pos=base["gt_actions"][:, :3])
    if rot_type == "euler":
        gt[0, 3:6] = [0.95, -0.97, 0.1]
    cfg = model_cfg("SimplePolicyPTV3CA", act={
        "pos_pred_type": pos_type, "reduce": reduce,
        "rot_pred_type": rot_type, "dim_actions": dim})
    port = check_policy(cfg, policy_batch(seed=5, gt=gt))
    head = port.act_proj_head
    assert head.heatmap_mlp_fc2.out_features == (
        4 if pos_type == "heatmap_mlp" else 3 * ACT["pos_bins"] * 2)


@pytest.mark.parametrize("kw", [{"pos_pred_type": "heatmap_sphere"},
                                {"reduce": "median"},
                                {"rot_pred_type": "axis_angle"}])
def test_head_raises_where_jax_raises(kw):
    x = jnp.zeros((1, 4, 16))
    m = jnp.ones((1, 4), bool)
    with pytest.raises(NotImplementedError):
        JaxActionHead(hidden_size=16, **kw).init(jax.random.PRNGKey(0), x, m)
    with pytest.raises(NotImplementedError):
        ActionHead(torch.Generator(), hidden_size=16, **kw)


# --------------------------------------------------------------- ens1 --

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ens1_decode_bit_equal_jax(seed):
    """Random logits over 50 points x 20 bins per axis, a masked tail,
    coordinates spread over the +-2.56 m vote range: the port's 5 mm vote
    picks the JAX one's voxels (positions equal), twice alike."""
    rng = np.random.RandomState(seed)
    B, N, nb = 2, 50, 20
    logits = (rng.randn(B, 3, N, nb) * 3).astype(np.float32)
    xyz = rng.uniform(-0.3, 0.3, (B, N, 3)).astype(np.float32)
    mask = np.arange(N)[None] < np.array([[N], [N - 11]])
    kw = dict(pos_bin_size=0.01, pos_bins=nb // 2)
    want = jax.vmap(lambda lg, x, m: jpos.best_pos_from_disc_logits(
        lg, x, mask=m, best="ens1", **kw))(jnp.asarray(logits),
                                             jnp.asarray(xyz),
                                             jnp.asarray(mask))
    got = best_pos_from_disc_logits(T(logits), T(xyz), T(mask), best="ens1",
                                    **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, best_pos_from_disc_logits(
        T(logits), T(xyz), T(mask), best="ens1", **kw))
    with pytest.raises(NotImplementedError):
        best_pos_from_disc_logits(T(logits), T(xyz), best="ens2")


# ----------------------------------------------------------- actioner --

def _actioner_config(tmp_path, num_points=128):
    """Stage capacities that cannot overflow at any point bucket, so that
    a cloud's action does not depend on its bucket, and the release grid
    depth (a tabletop cloud spans more than 2^6 cells of 1 cm)."""
    cfg = model_cfg("SimplePolicyPTV3CA", {"stage_caps": [num_points] * 2,
                                           "serial_depth": 10},
                    {"use_ee_pose": True, "use_step_id": True})
    doc = {"TRAIN_DATASET": {"num_points": num_points,
                             "rm_robot": "box_keep_gripper",
                             "rm_table": True, "xyz_shift": "center",
                             "use_height": True},
           "MODEL": cfg}
    path = os.path.join(tmp_path, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    return path


ENSEMBLE_PERMS = [[2, 0, 3, 1], [1, 3, 0, 2], [3, 2, 1, 0], [0, 2, 1, 3],
                  [2, 3, 0, 1], [1, 0, 3, 2]]


def test_ensemble_ens1_actioner_matches_jax(tmp_path, monkeypatch):
    """num_ensembles = 3 with best_disc_pos 'ens1' and the pose and step
    tokens: the JAX Actioner (its forwards unjitted, so that each member
    draws its own injected order permutations) against the port's, whose
    members get the same permutations; the same variables. The averaged
    action within 1e-4 (the rotation through scipy's euler mean on both
    sides)."""
    cfg = _actioner_config(tmp_path)
    jact = JaxActioner(cfg, num_ensembles=3, best_disc_pos="ens1")
    port = Actioner(cfg, device="cpu", num_ensembles=3, best_disc_pos="ens1")
    port.model.load_state_dict(params_from_jax(jact.variables), strict=True)
    # 82 points: no subsample (the packages draw it from different
    # generators)
    obs = synthetic_observation(11, cameras=1, height=12, width=12)
    assert 10 < len(port._host_prep("close_jar", 0, obs, None)[1]) < 128
    payload = {"task_str": "close_jar", "variation": 0, "step_id": 2,
               "obs_state_dict": obs}

    calls = []

    def permutation(rng, n):
        calls.append(n)
        return jnp.asarray(ENSEMBLE_PERMS[len(calls) - 1])
    monkeypatch.setattr(jax.random, "permutation", permutation)
    with jax.disable_jit():
        want = jact.predict(**payload)["action"]
    assert calls == [4] * 6          # 3 members x (stage 0 + 1 pooling)

    members = [ENSEMBLE_PERMS[2 * i:2 * i + 2] for i in range(3)]
    monkeypatch.setattr(port, "_ensemble_rngs", lambda: [
        Randomness(0, perms=p) for p in members])
    got = port.predict(**payload)["action"]
    assert got.shape == (8,) and np.isfinite(got).all()
    np.testing.assert_allclose(got[:7], want[:7], atol=ATOL, rtol=0)
    assert got[7] == want[7]


def test_pose_and_step_reach_the_model_on_both_paths(tmp_path):
    """A CA policy with pose and step tokens: the fused path's action
    equals the host path's on a sparse observation (no subsample) at two
    step ids, and the step id and the gripper pose move the open logit."""
    cfg = _actioner_config(tmp_path, num_points=1024)
    host = Actioner(cfg, device="cpu", seed=1)
    fused = Actioner(cfg, device="cpu", seed=1, device_preprocess=True,
                     vox_capacity=2048)
    perturb_port(host.model)
    fused.model.load_state_dict(host.model.state_dict())
    obs = synthetic_observation(6, cameras=1, height=32, width=32)
    assert 10 < len(host._host_prep("close_jar", 0, obs, None)[1]) < 1024
    for step in (0, 5):
        payload = {"task_str": "close_jar", "variation": 0, "step_id": step,
                   "obs_state_dict": obs}
        want = host.predict(**payload)["action"]
        got = fused.predict(**payload)["action"]
        np.testing.assert_allclose(got[:3], want[:3], atol=2e-4)
        np.testing.assert_allclose(got[3:7], want[3:7], atol=1e-4)
        assert got[7] == want[7]
    emb, pc_ft, _, _, ee = host._host_prep("close_jar", 0, obs, None)
    moved = ee.copy()
    moved[:3] += 0.05
    logits = [host._forward([(pc_ft, emb, e, s)], 1)[0, 7]
              for e, s in ((ee, 0), (ee, 5), (moved, 0))]
    assert logits[0] != logits[1] and logits[0] != logits[2]


# ---------------------------------------------------------- training --

def check_train_step(port_cfg, jmodel, jloss_fn, loss_fn, batch, perms,
                     monkeypatch, must_learn=()):
    """One whole step of the port (Trainer, FlatAdamW) against the JAX
    make_train_step on the same perturbed variables and the same order
    permutations: the losses and every updated parameter and running
    statistic within 1e-4 * max(1, |ref|); every gradient within 1e-4 of
    its leaf's largest |grad|, floored at 1e-3 of the largest of all;
    the leaves of `must_learn` above that floor. Adam's first step moves
    an element by about lr sign(grad), so where the reference gradient is
    within the gradient bar of zero (its sign not determined by the
    check) the two updates are held to 2 lr apart instead."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b: jmodel.init(
        {"params": key, "dropout": key, "shuffle": key}, b,
        deterministic=True))(jb)
    variables = _perturb(jax.tree_util.tree_map(np.asarray, dict(variables)))
    calls = []

    def permutation(rng, n):
        calls.append(n)
        return jnp.asarray(perms[(len(calls) - 1) % len(perms)])
    monkeypatch.setattr(jax.random, "permutation", permutation)

    def compute(params):
        preds, mutated = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jb,
            deterministic=False, rngs={"dropout": key, "shuffle": key},
            mutable=["batch_stats"])
        losses = jloss_fn(preds, jb)
        return losses["total"], (losses, mutated)
    (_, (jlosses, mutated)), jgrads = jax.jit(jax.value_and_grad(
        compute, has_aux=True))(variables["params"])
    tx, _ = jbuild_optimizer(variables["params"], TRAIN)
    state = TrainState.create(apply_fn=jmodel.apply,
                              params=variables["params"], tx=tx,
                              batch_stats=variables["batch_stats"])
    new_state, step_losses = make_train_step(jmodel, jloss_fn,
                                             donate=False)(state, jb, key)

    port = build_model(port_cfg, device="cpu")
    port.load_state_dict(params_from_jax(variables), strict=True)
    opt, _ = build_optimizer(port, TRAIN)
    trainer = Trainer(port, loss_fn, opt, Randomness(0, perms=perms))
    losses = trainer.step(batch_to_device(batch, "cpu"))
    assert set(losses) == set(jlosses)
    for k in jlosses:
        close(losses[k], jlosses[k], k)
        close(losses[k], step_losses[k], k)
    grads = params_from_jax({"params": jgrads})
    named = dict(port.named_parameters())
    assert set(grads) == set(named)
    scales = {k: float(np.abs(np.asarray(g)).max()) for k, g in grads.items()}
    floor = 1e-3 * max(scales.values())
    for k in must_learn:
        assert scales[k] >= floor, k
    for k, g in grads.items():
        np.testing.assert_allclose(
            named[k].grad.numpy(), np.asarray(g), rtol=0,
            atol=ATOL * max(scales[k], floor), err_msg=f"grad {k}")
    updated = params_from_jax({"params": new_state.params,
                               "batch_stats": new_state.batch_stats})
    ref_stats = params_from_jax({"params": {},
                                 "batch_stats": mutated["batch_stats"]})
    sd = port.state_dict()
    assert set(updated) == set(sd)
    lr = TRAIN["learning_rate"]
    for k, v in updated.items():
        if k in grads:
            unsigned = T(np.abs(np.asarray(grads[k])) <=
                         ATOL * max(scales[k], floor))
            diff = torch.where(unsigned, (sd[k] - v).abs(), 0.0)
            assert float(diff.max()) <= 2 * lr, k
            close(torch.where(unsigned, v, sd[k]), v, k)
            continue
        close(sd[k], v, k)
    for k, v in ref_stats.items():
        close(sd[k], v, k)


def test_adanorm_train_step_matches_jax(monkeypatch):
    cfg = model_cfg("SimplePolicyPTV3AdaNorm", {"pdnorm_adaptive": True},
                    {"txt_reduce": "attn", "use_ee_pose": True,
                     "use_step_id": True})
    act = cfg["action_config"]
    check_train_step(
        cfg, jax_policy(cfg), lambda p, b: jloss(p, b, act, LOSS),
        lambda p, b: compute_loss(p, b, act, LOSS), policy_batch(seed=2),
        [[2, 0, 3, 1], [1, 3, 0, 2]], monkeypatch,
        must_learn=("txt_fc.weight", "txt_attn_fc.weight",
                    "pose_embedding.rot_embedding.weight",
                    "stepid_embedding.weight",
                    "ptv3_model.enc0_block0.norm1.modulation.weight"))


# -------------------------------------------------------------- data --

DS_CFG = dict(num_points=256, taskvar_file=None, instr_embed_file=None,
              taskvar_instr_file=None, txt_embed_dim=32, augment_pc=True)


def _batches(jds, pds, jcol=None, pcol=None, n=3):
    assert pds.data_ids == jds.data_ids
    jl = jloader.KeystepBatchLoader(
        jds, 4, 256, seed=5, shuffle_seed=9, process_index=0,
        process_count=1, num_workers=0, collate_fn=jcol)
    pl = loader.KeystepBatchLoader(pds, 4, 256, seed=5, shuffle_seed=9,
                                   num_workers=0, collate_fn=pcol)
    out = []
    for got, want in zip(pl, jl):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        out.append(got)
        if len(out) == n:
            return out


@pytest.mark.parametrize("rot_type,width", [("quat", 8), ("euler", 7),
                                            ("euler_delta", 7),
                                            ("rot6d", 10)])
def test_keystep_rot_targets_bit_equal_jax(rot_type, width):
    kw = dict(DS_CFG, rot_type=rot_type)
    args = dict(num_taskvars=2, episodes_per_taskvar=2, steps_per_episode=3,
                points_per_step=1500, seed=3, action_mode="random")
    jds = JKeystepDataset(jstore.SyntheticStore(**args),
                          rng=np.random.RandomState(11), **kw)
    pds = KeystepDataset(store.SyntheticStore(**args),
                         rng=np.random.RandomState(11), **kw)
    for b in _batches(jds, pds):
        assert b["gt_actions"].shape[-1] == width


def test_keystep_continuous_pos_type_bit_equal_jax():
    """pos_type other than 'disc': no robot-point mask in the batch."""
    kw = dict(DS_CFG, rot_type="quat", pos_type="cont")
    args = dict(num_taskvars=2, episodes_per_taskvar=2, steps_per_episode=3,
                points_per_step=1500, seed=4, action_mode="random")
    jds = JKeystepDataset(jstore.SyntheticStore(**args),
                          rng=np.random.RandomState(12), **kw)
    pds = KeystepDataset(store.SyntheticStore(**args),
                         rng=np.random.RandomState(12), **kw)
    for b in _batches(jds, pds):
        assert "pc_robot_mask" not in b


@pytest.mark.parametrize("rot_type,width", [("quat", 8), ("euler", 7),
                                            ("euler_delta", 8),
                                            ("rot6d", 10)])
def test_motion_rot_targets_bit_equal_jax(rot_type, width):
    """euler_delta keeps the trajectory's quaternions, in both packages."""
    kw = dict(DS_CFG, rot_type=rot_type)
    args = dict(num_taskvars=2, episodes_per_taskvar=2, steps_per_episode=3,
                points_per_step=1500, seed=3)
    jds = JMotionDataset(jstore.SyntheticMotionStore(**args),
                         rng=np.random.RandomState(11), **kw)
    pds = MotionPlannerDataset(store.SyntheticMotionStore(**args),
                               rng=np.random.RandomState(11), **kw)
    out = _batches(jds, pds,
                   lambda c: jcollate_motion(c, 256, 5, num_clouds=4),
                   lambda c: collate_motion_samples(c, 256, 5, num_clouds=4))
    for b in out:
        assert b["gt_trajs"].shape[-1] == width


# -------------------------------------------------------- checkpoints --

@pytest.mark.parametrize("cls", ["SimplePolicyPTV3AdaNorm",
                                 "SimplePolicyPTV3Concat"])
def test_new_class_model_files_load_in_port(cls, tmp_path):
    """A JAX model file (.msgpack, its ModelSaver) and an upstream-layout
    .pt (the JAX save_torch_checkpoint: PDNorm modulation, pose and step
    embeddings, txt_attn_fc, the Concat stem) of each new class, loaded
    by the port bit-equal to the variables; a port file read back the
    same."""
    cfg = model_cfg(cls, {"pdnorm_adaptive": True},
                    {"txt_reduce": "attn", "use_ee_pose": True,
                     "use_step_id": True})
    jmodel = jax_policy(cfg)
    batch = policy_batch()
    port, variables = carried(cfg, jmodel,
                              {k: jnp.asarray(v) for k, v in batch.items()})
    want = params_from_jax(variables)
    tx, _ = jbuild_optimizer(variables["params"], TRAIN)
    state = TrainState.create(apply_fn=jmodel.apply,
                              params=variables["params"], tx=tx,
                              batch_stats=variables["batch_stats"])
    path = jckpt.ModelSaver(str(tmp_path)).save(state, 3)
    pt = str(tmp_path / "model_step_3.pt")
    jtc.save_torch_checkpoint(pt, variables["params"],
                              variables["batch_stats"], cfg)
    fresh = build_model(cfg, device="cpu", seed=9)
    for f in (path, pt):
        sd = ckpt.load_any_model_ckpt(f, fresh, cfg)
        assert set(sd) == set(want)
        for k in want:
            assert torch.equal(sd[k], want[k]), (f, k)
    own = ckpt.ModelSaver(str(tmp_path / "port")).save(port, 4)
    sd = ckpt.load_any_model_ckpt(own, fresh)
    for k in want:
        assert torch.equal(sd[k], want[k]), k
