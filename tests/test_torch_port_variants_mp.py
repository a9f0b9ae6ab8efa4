"""PyTorch port vs the JAX package: the motion planner's conditioning
variants, its pose token and its head types.

The tiny motion planner of test_torch_port_motion_planner.py (2 stages,
the k=5 stem with its categorical label channel) on the CPU, the JAX side
on its exact XLA paths, with the helpers of test_torch_port_variants.py:
  * the eval forward of MotionPlannerPTV3AdaNorm (txt_reduce mean / attn)
    and MotionPlannerPTV3CA, pdnorm_only_decoder True / False, the pose
    token on / off: the perturbed seeded port weights carried to the JAX
    tree by params_to_jax (the JAX init's structure and shapes, inverted
    bit for bit by params_from_jax); logits, compute_mp_loss and the
    decoded trajectories within 1e-4;
  * the other TrajActionHead types (heatmap_mlp; reduce mean; quat, rot6d,
    euler): outputs, loss and decode; reduce 'attn' raises in both;
  * one whole train step of MotionPlannerPTV3AdaNorm (txt_reduce attn, the
    pose token) against the JAX make_train_step;
  * MotionPlannerEngine serving the AdaNorm class from a JAX .msgpack and
    an upstream-layout .pt: the state bit-equal to the variables, the
    trajectory within 1e-4 of the JAX engine's on the same file.
"""
import numpy as np
import pytest
import torch
import yaml
import jax
import jax.numpy as jnp

from robot3dlotus_tpu.eval import robot_pipeline as jpipe
from robot3dlotus_tpu.models.motion_planner import (
    MotionPlannerTPU, TrajActionHead as JaxTrajHead,
    compute_mp_loss as jloss, decode_mp_actions as jdecode)
from robot3dlotus_tpu.train import checkpoint as jckpt
from robot3dlotus_tpu.train import torch_convert as jtc
from robot3dlotus_tpu.train.optim import build_optimizer as jbuild_optimizer
from robot3dlotus_tpu.train.trainer import TrainState
from robot3dlotus_tpu_torch.convert import params_from_jax
from robot3dlotus_tpu_torch.eval import robot_pipeline as pipe
from robot3dlotus_tpu_torch.models.motion_planner import (TrajActionHead,
                                                          compute_mp_loss,
                                                          decode_mp_actions)
from robot3dlotus_tpu_torch.train.trainer import batch_to_device
from test_torch_port_motion_planner import ACT, LOSS, PTV3, mp_batch
from test_torch_port_variants import (ATOL, JAX_IMPL, TRAIN, carried,
                                      check_train_step, close, ee_poses)

MP = {"MotionPlannerPTV3AdaNorm": "adanorm", "MotionPlannerPTV3CA": "ca"}


def mp_cfg(cls, ptv3=None, act=None):
    return {"model_class": cls, "ptv3_config": dict(PTV3, **(ptv3 or {})),
            "action_config": dict(ACT, **(act or {}))}


def jax_mp(cfg):
    return MotionPlannerTPU(ptv3_cfg=dict(cfg["ptv3_config"], **JAX_IMPL),
                            act_cfg=cfg["action_config"],
                            variant=MP[cfg["model_class"]])


def batch_with_pose(seed=0, gt=None):
    batch = mp_batch(seed)
    batch["ee_poses"] = ee_poses(np.random.RandomState(seed + 100), 2)
    if gt is not None:
        batch["gt_trajs"] = gt
    return batch


def check_mp(cfg, batch):
    jmodel, act = jax_mp(cfg), cfg["action_config"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    port, variables = carried(cfg, jmodel, jb)
    keys = ("pos", "rot", "open", "stop")

    @jax.jit
    def run(v, b):
        p = jmodel.apply(v, b, deterministic=True)
        return ({k: p[k] for k in keys}, jloss(p, b, act, LOSS),
                jdecode(p, act))
    preds, losses, actions = run(variables, jb)
    tb = batch_to_device(batch, "cpu")
    with torch.no_grad():
        got = port(tb)
        got_losses = compute_mp_loss(got, tb, act, LOSS)
        got_actions = decode_mp_actions(got, act)
    for k in keys:
        close(got[k], preds[k], k)
    for k in losses:
        close(got_losses[k], losses[k], f"loss {k}")
    np.testing.assert_allclose(got_actions.numpy(), np.asarray(actions),
                               atol=ATOL, rtol=0)
    return port


FORWARD_CASES = [
    (cls, reduce, only_dec, pose)
    for cls in MP for reduce in ("mean", "attn")
    for only_dec in (False, True) for pose in (False, True)
    if not (cls == "MotionPlannerPTV3CA" and reduce == "mean")]


@pytest.mark.parametrize("cls,reduce,only_dec,pose", FORWARD_CASES)
def test_mp_variant_forward_matches_jax(cls, reduce, only_dec, pose):
    cfg = mp_cfg(cls, {"pdnorm_only_decoder": only_dec,
                       "pdnorm_adaptive": True},
                 {"txt_reduce": reduce, "use_ee_pose": pose,
                  "use_step_id": True})
    port = check_mp(cfg, batch_with_pose())
    names = {k for k, _ in port.named_parameters()}
    assert ("pose_embedding.layer_norm.weight" in names) == pose
    assert "stepid_embedding.weight" not in names     # never read
    assert any(".modulation." in n for n in names) == (
        cls == "MotionPlannerPTV3AdaNorm")
    assert any("_cablock" in n for n in names) == (
        cls == "MotionPlannerPTV3CA")


def _gt_trajs(rng, rot_type, pos, L=5):
    B = pos.shape[0]
    if rot_type == "quat":
        rot = rng.randn(B, L, 4)
        rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    elif rot_type == "rot6d":
        rot = rng.randn(B, L, 6)
    else:
        rot = rng.uniform(-1, 1, (B, L, 3))
    return np.concatenate([pos, rot, rng.randint(0, 2, (B, L, 1))],
                          -1).astype(np.float32)


@pytest.mark.parametrize("pos_type,reduce,rot_type,dim", [
    ("heatmap_mlp", "mean", "quat", 8), ("heatmap_disc", "max", "rot6d", 10),
    ("heatmap_mlp", "max", "euler", 7)])
def test_mp_head_types_match_jax(pos_type, reduce, rot_type, dim):
    base = batch_with_pose(seed=6)
    gt = _gt_trajs(np.random.RandomState(dim), rot_type,
                   base["gt_trajs"][..., :3])
    cfg = mp_cfg("MotionPlannerPTV3AdaNorm", {"pdnorm_adaptive": True},
                 {"pos_pred_type": pos_type, "reduce": reduce,
                  "rot_pred_type": rot_type, "dim_actions": dim})
    check_mp(cfg, batch_with_pose(seed=6, gt=gt))


def test_mp_head_attn_reduce_raises_like_jax():
    x = jnp.zeros((1, 4, 16))
    m = jnp.ones((1, 4), bool)
    with pytest.raises(NotImplementedError):
        JaxTrajHead(hidden_size=16, reduce="attn", traj_embed_size=4).init(
            jax.random.PRNGKey(0), x, m)
    with pytest.raises(NotImplementedError):
        TrajActionHead(torch.Generator(), 16, reduce="attn", hidden_size=16)


def test_mp_adanorm_train_step_matches_jax(monkeypatch):
    cfg = mp_cfg("MotionPlannerPTV3AdaNorm", {"pdnorm_adaptive": True},
                 {"txt_reduce": "attn", "use_ee_pose": True})
    act = cfg["action_config"]
    check_train_step(
        cfg, jax_mp(cfg), lambda p, b: jloss(p, b, act, LOSS),
        lambda p, b: compute_mp_loss(p, b, act, LOSS), batch_with_pose(3),
        [[3, 1, 0, 2], [1, 2, 3, 0]], monkeypatch,
        must_learn=("txt_fc.weight", "txt_attn_fc.weight",
                    "pose_embedding.pos_embedding.weight",
                    "pc_label_embedding.weight",
                    "ptv3_model.embedding_norm.modulation.weight"))


def test_engine_serves_adanorm_checkpoints(tmp_path):
    cfg = mp_cfg("MotionPlannerPTV3AdaNorm",
                 {"pdnorm_adaptive": True, "stage_caps": [256, 256]},
                 {"txt_reduce": "attn", "use_ee_pose": True})
    cfg_path = str(tmp_path / "mp.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"TRAIN_DATASET": {"num_points": 256},
                        "MODEL": cfg}, f)
    jmodel = jax_mp(cfg)
    batch = batch_with_pose()
    _, variables = carried(cfg, jmodel,
                           {k: jnp.asarray(v) for k, v in batch.items()})
    tx, _ = jbuild_optimizer(variables["params"], TRAIN)
    state = TrainState.create(apply_fn=jmodel.apply,
                              params=variables["params"], tx=tx,
                              batch_stats=variables["batch_stats"])
    jfile = jckpt.ModelSaver(str(tmp_path)).save(state, 1)
    pt = str(tmp_path / "mp.pt")
    jtc.save_torch_checkpoint(pt, variables["params"],
                              variables["batch_stats"], cfg)
    want_sd = params_from_jax(variables)
    rng = np.random.RandomState(0)
    n = 200
    args = (rng.randn(n, 4).astype(np.float32), rng.randint(0, 4, n),
            rng.randn(3, 64).astype(np.float32),
            ee_poses(rng, 1)[0], np.zeros(3), 1.0, 0.0)
    want = jpipe.MotionPlannerEngine(cfg_path, checkpoint=jfile).predict(
        *args)
    for path in (jfile, pt):
        e = pipe.MotionPlannerEngine(cfg_path, checkpoint=path, device="cpu")
        sd = e.model.state_dict()
        assert set(sd) == set(want_sd)
        for k, v in want_sd.items():
            assert torch.equal(sd[k], v), (path, k)
        np.testing.assert_allclose(e.predict(*args), want, atol=ATOL, rtol=0)
