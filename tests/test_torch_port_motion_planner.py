"""PyTorch port vs the JAX package: the 3D-LOTUS++ motion planner.

Both packages run on the same numpy inputs (one seed) at a small size: 2
stages, narrow widths, 128-256 points, the k=5 stem with its categorical
label channel. Tolerances, fp32 on both sides:
  * K9's plain version against the JAX small-C gather kernel in interpret
    mode: exact (a copy), sentinel rows included; K10's against the JAX
    backward kernel: 1e-4 * max|ref| (other summation orders);
  * the categorical stem conv and its weight / label-table gradients
    against the JAX subm_conv_apply (exact XLA path and the K9 interpret
    path): 1e-4 * max(1, |ref|);
  * the whole MotionPlannerTPU(variant='ca') forward (weights carried by
    convert.params_from_jax, load_state_dict strict): logits within
    1e-4 * max(1, |ref|) over the unmasked entries, decoded trajectories
    within 1e-5; compute_mp_loss within 1e-4;
  * SyntheticMotionStore episodes, MotionPlannerDataset samples and
    collate_motion_samples bit-equal; GroundtruthVision labels equal;
    GroundtruthRobotPipeline.predict over 3 steps within 1e-4.
The whole training step: test_torch_port_mp_train.py. The kernels on the
card: test_torch_port_gpu.py and chip_smoke.py.
"""
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robot3dlotus_tpu.configs.node import ConfigNode
from robot3dlotus_tpu.eval import robot_pipeline as jpipe
from robot3dlotus_tpu.models.motion_planner import (
    MotionPlannerTPU, compute_mp_loss as jloss, decode_mp_actions as jdecode)
from robot3dlotus_tpu.ops import pallas_gather as jgather
from robot3dlotus_tpu.ops import sparse_conv as jsparse
from robot3dlotus_tpu.train.datasets import motion_dataset as jmd
from robot3dlotus_tpu.train.datasets.store import \
    SyntheticMotionStore as JStore
from robot3dlotus_tpu_torch.convert import params_from_jax
from robot3dlotus_tpu_torch.eval import robot_pipeline as pipe
from robot3dlotus_tpu_torch.eval.synthetic_obs import (TASKVAR,
                                                       synthetic_observation)
from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.models.motion_planner import (compute_mp_loss,
                                                          decode_mp_actions)
from robot3dlotus_tpu_torch.ops import gather, sparse_conv
from robot3dlotus_tpu_torch.train.datasets import motion_dataset as md
from robot3dlotus_tpu_torch.train.datasets.store import SyntheticMotionStore

ATOL = 1e-4
PTV3 = {
    "in_channels": 4, "orders": ["z", "z-trans", "hilbert", "hilbert-trans"],
    "stride": [2], "enc_depths": [1, 1], "enc_channels": [16, 32],
    "enc_num_head": [2, 2], "enc_patch_size": [16, 16], "dec_depths": [1],
    "dec_channels": [16], "dec_num_head": [2], "dec_patch_size": [16],
    "qkv_bias": True, "qk_norm": True, "attn_drop": 0.0, "proj_drop": 0.0,
    "drop_path": 0.0, "shuffle_orders": True, "serial_depth": 6,
    "stem_kernel": 5, "stage_caps": [128, 128],
}
ACT = {
    "voxel_size": 0.01, "context_channels": 32, "txt_ft_size": 64,
    "txt_reduce": "attn", "use_ee_pose": False, "use_step_id": False,
    "reduce": "max", "max_traj_len": 5, "traj_embed_size": 8,
    "pc_label_channels": 8, "dim_actions": 7, "pos_pred_type": "heatmap_disc",
    "pos_heatmap_temp": 0.1, "rot_pred_type": "euler_disc", "dropout": 0.0,
    "pos_bins": 5, "pos_bin_size": 0.01, "best_disc_pos": "max",
    "euler_resolution": 5, "pos_heatmap_type": "dist",
}
LOSS = {"pos_weight": 1.0, "rot_weight": 1.0}
MP_MODEL = {"model_class": "MotionPlannerPTV3CA", "ptv3_config": PTV3,
            "action_config": ACT}


def T(a):
    return torch.from_numpy(np.array(a))


def mp_batch(seed=0, B=2, N=128, T_txt=3, L=5, span=12):
    """Clouds on voxel centres with ten duplicated voxels each (the conv's
    input gradient must stay exact), labels 0-3, trajectories of 5 and 3
    steps, a robot mask, one text length short of its bucket."""
    rng = np.random.RandomState(seed)
    counts = np.array([N, N - 27][:B], np.int32)
    mask = np.arange(N)[None] < counts[:, None]
    pc = np.zeros((B, N, 4), np.float32)
    labels = np.zeros((B, N), np.int32)
    for b in range(B):
        flat = rng.choice(span ** 3, counts[b], replace=False)
        gc = np.stack(np.unravel_index(flat, (span,) * 3), -1)
        gc = gc - gc.min(0)
        pc[b, :counts[b], :3] = np.where(gc > 0, gc + 0.5, 0.0) * 0.01 - 0.05
        pc[b, :counts[b], 3] = pc[b, :counts[b], 2] + 0.05
        pc[b, 90:100, :3] = pc[b, 10:20, :3]
        labels[b, :counts[b]] = rng.randint(0, 4, counts[b])
    gt = np.zeros((B, L, 7), np.float32)
    gt[..., :3] = pc[:, 7:8, :3] + rng.uniform(-0.03, 0.03, (B, L, 3))
    gt[..., 3:6] = rng.randint(0, 72, (B, L, 3))
    gt[..., 6] = rng.randint(0, 2, (B, L))
    tmask = np.ones((B, L), bool)
    tmask[1, 3:] = False
    stops = (np.arange(L)[None] >= np.array([[4], [2]])).astype(np.float32)
    txt_mask = np.ones((B, 4), bool)
    txt_mask[:, T_txt:] = False
    return {"pc_fts": pc, "pc_labels": labels, "pc_mask": mask,
            "pc_counts": counts,
            "txt_embeds": rng.randn(B, 4, 64).astype(np.float32),
            "txt_mask": txt_mask, "gt_trajs": gt, "gt_trajs_stop": stops,
            "traj_masks": tmask,
            "pc_robot_mask": (rng.rand(B, N) < 0.1) & mask,
            "batch_valid": np.ones(B, bool)}


def jax_model():
    return MotionPlannerTPU(ptv3_cfg=dict(PTV3, attn_impl="xla",
                                          conv_impl="xla"),
                            act_cfg=ACT, variant="ca")


def perturb(variables, seed=1):
    """Random biases, norm scales and running statistics on top of the JAX
    init, so every leaf is exercised."""
    rng = np.random.RandomState(seed)

    def walk(tree, stats):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, stats)
                continue
            a = np.asarray(v, np.float32)
            if stats and k == "var":
                a = a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            else:
                a = a + (rng.randn(*a.shape) * 0.1).astype(np.float32)
            out[k] = a
        return out
    return {"params": walk(variables["params"], False),
            "batch_stats": walk(variables["batch_stats"], True)}


def jax_variables(batch):
    key = jax.random.PRNGKey(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda b: jax_model().init(
        {"params": key, "dropout": key, "shuffle": key}, b,
        deterministic=True))(jb)
    return perturb(jax.tree_util.tree_map(np.asarray, dict(variables)))


def _close_valid(got, want, name, tol=ATOL):
    """Within tol * max(1, |ref|) over the entries the model does not mask
    (masked position logits hold -1e9 on both sides)."""
    want = np.asarray(want)
    got = got.detach().numpy()
    live = want > -1e8
    np.testing.assert_array_equal(got <= -1e8, ~live, err_msg=name)
    scale = max(1.0, float(np.abs(want[live]).max()))
    np.testing.assert_allclose(got[live], want[live], atol=tol * scale,
                               rtol=0, err_msg=name)


# ------------------------------------------------------------- K9 / K10 ---

def _smallc_inputs(seed, C, K, B=2, N=256):
    """x (B, N, C) and a flat (B, N*K) index with a fifth of the entries at
    the sentinel N and a few negative ones."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, C).astype(np.float32)
    idx = rng.randint(0, N, (B, N * K)).astype(np.int32)
    idx[rng.rand(B, N * K) < 0.2] = N
    idx[:, :7] = -3
    return x, idx


@pytest.mark.parametrize("C,K", [(5, 125), (4, 1), (20, 27)])
def test_k9_plain_matches_jax_smallc_kernel(C, K):
    x, idx = _smallc_inputs(0, C, K)
    got = gather.gather_rows_smallc(T(x), T(idx)).numpy()
    want = jgather._smallc_fwd_call(jnp.asarray(x), jnp.asarray(idx),
                                    interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(
        got, np.asarray(jgather._take_rows_zero_oob(jnp.asarray(x),
                                                    jnp.asarray(idx))))
    assert not got[idx >= x.shape[1]].any() and not got[idx < 0].any()


@pytest.mark.parametrize("C", [5, 20])
def test_k10_plain_matches_jax_smallc_backward(C):
    x, idx = _smallc_inputs(1, C, 125)
    g = np.random.RandomState(2).randn(*idx.shape, C).astype(np.float32)
    got = gather.scatter_rows_smallc_add(T(g), T(idx), x.shape[1]).numpy()
    want = np.asarray(jgather._smallc_bwd_call(
        jnp.asarray(idx), jnp.asarray(g), x.shape[1], True))
    np.testing.assert_allclose(got, want, atol=ATOL * np.abs(want).max(),
                               rtol=0)
    # the autograd Function's backward is the same scatter-add
    xt = T(x).requires_grad_()
    gather.gather_rows_smallc(xt, T(idx)).backward(T(g))
    np.testing.assert_allclose(xt.grad.numpy(), got, atol=1e-6, rtol=0)


def test_permute_rows_any_matches_take_rows():
    rng = np.random.RandomState(3)
    order = torch.from_numpy(np.stack([rng.permutation(64)] * 2))
    for C in (4, 32, 64):
        x = torch.from_numpy(rng.randn(2, 64, C).astype(np.float32))
        np.testing.assert_array_equal(
            gather.permute_rows_any(x, order).numpy(),
            np.asarray(jgather._take_rows(jnp.asarray(x.numpy()),
                                          jnp.asarray(order.numpy()))))


# ------------------------------------------------------ categorical stem --

@pytest.mark.parametrize("interpret", [False, True])
def test_categorical_stem_matches_jax(monkeypatch, interpret):
    """The port's categorical conv (K9 with sentinel rows, reconstruct, ok
    mask, one product) and its weight and label-table gradients against the
    JAX subm_conv_apply: its exact XLA path (materialized embedding,
    streaming conv) or, with the test seam set, its K9 path in interpret
    mode."""
    monkeypatch.setattr(jsparse, "_SMALLC_INTERPRET", interpret)
    rng = np.random.RandomState(4)
    B, N, E = 2, 256, 8
    gc = rng.randint(0, 9, (B, N, 3)).astype(np.int32)
    mask = np.arange(N)[None] < np.array([[N], [N - 40]])
    jn = jsparse.build_neighbor_map(jnp.asarray(gc), jnp.asarray(mask), 5, 4,
                                    extent=16)
    nm = sparse_conv.NeighborMap(T(jn.idx), T(jn.ok))
    feat = rng.randn(B, N, 4).astype(np.float32)
    labels = rng.randint(0, 4, (B, N)).astype(np.int32)
    table = (rng.randn(4, E) * 0.5).astype(np.float32)
    w = (rng.randn(125, 4 + E, 16) * 0.1).astype(np.float32)
    gout = rng.randn(B, N, 16).astype(np.float32)

    def jfn(w_, t_):
        return jsparse.subm_conv_apply(jnp.asarray(feat), jn, w_,
                                       categorical=(jnp.asarray(labels), t_))
    want, vjp = jax.vjp(jfn, jnp.asarray(w), jnp.asarray(table))
    jdw, jdt = vjp(jnp.asarray(gout))
    wt, tt = T(w).requires_grad_(), T(table).requires_grad_()
    got = sparse_conv.subm_conv_apply(T(feat), nm, wt,
                                      categorical=(T(labels), tt))
    got.backward(T(gout))
    for a, b, name in ((got, want, "out"), (wt.grad, jdw, "dW"),
                       (tt.grad, jdt, "dtable")):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                   atol=ATOL * max(1.0, np.abs(b).max()),
                                   err_msg=name)


def test_categorical_stem_rejects_wide_input():
    """The index channel rides K9 beside the features, so a categorical
    input of more than SMALLC_MAX - 1 channels raises instead of taking an
    unchecked route."""
    B, N, C = 1, 8, gather.SMALLC_MAX
    nm = sparse_conv.NeighborMap(torch.zeros(B, N, 125, dtype=torch.int32),
                                 torch.ones(B, N, 125, dtype=torch.bool))
    with pytest.raises(ValueError, match="channels"):
        sparse_conv.subm_conv_apply(
            torch.zeros(B, N, C), nm, torch.zeros(125, C + 4, 8),
            categorical=(torch.zeros(B, N, dtype=torch.int32),
                         torch.zeros(4, 4)))


# ------------------------------------------------------------ the model ---

@pytest.fixture(scope="module")
def forward_pair():
    batch = mp_batch()
    variables = jax_variables(batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jpreds = jax.jit(lambda v, b: jax_model().apply(v, b,
                                                    deterministic=True))(
        variables, jb)
    port = build_model(MP_MODEL, device="cpu")
    port.load_state_dict(params_from_jax(variables), strict=True)
    with torch.no_grad():
        preds = port({k: T(v) for k, v in batch.items()})
    return batch, jpreds, preds


def test_forward_matches_jax(forward_pair):
    batch, jpreds, preds = forward_pair
    assert preds["pos"].shape == (2, 5, 3, 128, 10)
    assert preds["rot"].shape == (2, 5, 72, 3)
    for k in ("pos", "rot", "open", "stop", "final_coord"):
        _close_valid(preds[k], jpreds[k], k)
    np.testing.assert_array_equal(preds["sort0"].numpy(),
                                  np.asarray(jpreds["sort0"]))
    np.testing.assert_array_equal(preds["final_mask"].numpy(),
                                  np.asarray(jpreds["final_mask"]))
    got = decode_mp_actions(preds, ACT).numpy()
    want = np.asarray(jdecode(jpreds, ACT))
    assert got.shape == (2, 5, 9) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_mp_loss_matches_jax(forward_pair):
    """compute_mp_loss on the JAX forward's outputs, with a padded cloud
    (batch_valid), short trajectories and a robot mask."""
    batch, jpreds, _ = forward_pair
    batch = dict(batch, batch_valid=np.array([True, False]))
    batch["traj_masks"][0, 4] = False
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jloss(jpreds, jb, ACT, LOSS)
    preds = {k: T(v) for k, v in jpreds.items()}
    got = compute_mp_loss(preds, {k: T(v) for k, v in batch.items()}, ACT,
                          LOSS)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   atol=ATOL * max(1.0, abs(float(want[k]))),
                                   rtol=0, err_msg=k)


# ------------------------------------------------------------- the data ---

def _equal(a, b, path="sample"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=path)


DS_CFG = dict(num_points=256, max_traj_len=5, pc_label_type="mix",
              pc_label_augment=0.3, augment_pc=True, aug_max_rot=45,
              rot_type="euler_disc", txt_embed_dim=64)


def test_synthetic_motion_store_and_dataset_match_jax(tmp_path):
    """Episodes, samples (label ids from a GT label table, so the object
    and target classes are present) and the collated batch, bit for bit."""
    jstore, store = JStore(), SyntheticMotionStore()
    tv, ep = store.taskvars()[1], store.episodes(store.taskvars()[1])[2]
    _equal(store.get(tv, ep), jstore.get(tv, ep), "episode")
    labels = {tv: [{"action": "grasp",
                    "object": {"name": "blob", "coarse": [1, 2, 3, 4, 5],
                               "fine": [6, 7, 8]}},
                   {"action": "move grasped object",
                    "object": {"name": "blob", "coarse": [1, 2, 3],
                               "fine": [1, 2]},
                    "target": {"name": "slab", "coarse": [9, 10, 11],
                               "fine": [9], "zrange": [0.7, 0.9]}}]}
    path = tmp_path / "labels.json"
    path.write_text(json.dumps(labels))
    kw = dict(DS_CFG, gt_act_obj_label_file=str(path),
              instr_include_objects=True)
    jsam = jmd.MotionPlannerDataset(
        jstore, rng=np.random.RandomState(5), **kw).get_episode_samples(tv, ep)
    sam = md.MotionPlannerDataset(
        store, rng=np.random.RandomState(5), **kw).get_episode_samples(tv, ep)
    assert len(sam) == 3 and {2, 3} <= set(np.unique(sam[2]["pc_labels"]))
    _equal(sam, jsam)
    extra = md.MotionPlannerDataset(store, rng=np.random.RandomState(6),
                                    **DS_CFG)[0]
    jextra = jmd.MotionPlannerDataset(jstore, rng=np.random.RandomState(6),
                                      **DS_CFG)[0]
    _equal(extra, jextra)
    _equal(md.collate_motion_samples(sam + extra, 256, 5, num_clouds=8),
           jmd.collate_motion_samples(jsam + jextra, 256, 5, num_clouds=8),
           "batch")


# ------------------------------------------------------ the GT pipeline ---

GT_CFG = {
    "llm_planner": {"use_groundtruth": True,
                    "gt_plan_file": "prompts/rlbench/in_context_examples.txt"},
    "object_grounding": {
        "gt_label_file": "assets/taskvars_target_label_zrange.json"},
    "motion_planner": {"config_file": None, "checkpoint": None,
                       "run_action_step": 1, "pc_label_type": "coarse"},
    "pipeline": {"restart": True},
}


def test_gt_vision_labels_match_jax():
    obs = synthetic_observation(11, cameras=2, height=96, width=96)
    args = (TASKVAR, 0, obs["pc"], obs["gt_mask"], obs["gripper"],
            obs["arm_links_info"])
    kw = dict(num_points=512, rm_robot="box_keep_gripper")
    got = pipe.GroundtruthVision(GT_CFG["object_grounding"]["gt_label_file"],
                                 rng=np.random.RandomState(0), **kw)(*args)
    want = jpipe.GroundtruthVision(
        GT_CFG["object_grounding"]["gt_label_file"],
        rng=np.random.RandomState(0), **kw)(*args)
    assert set(np.unique(got["pc_labels"])) == {0, 1, 2, 3}
    _equal(got, want, "vision")


@pytest.fixture(scope="module")
def mp_config_file(tmp_path_factory):
    cfg = ConfigNode({
        "MODEL": dict(MP_MODEL, ptv3_config=dict(
            PTV3, stage_caps=[256, 256], attn_impl="xla", conv_impl="xla"),
            action_config=dict(ACT, txt_ft_size=512)),
        "TRAIN_DATASET": {"num_points": 256, "xyz_shift": "center",
                          "xyz_norm": False, "use_height": True,
                          "rm_robot": "box_keep_gripper",
                          "same_npoints_per_example": False,
                          "pc_label_type": "coarse"},
    })
    path = tmp_path_factory.mktemp("mp") / "mp_config.yaml"
    with open(path, "w") as f:
        cfg.dump(f)
    return str(path)


def test_gt_pipeline_matches_jax(mp_config_file):
    """Three steps of one episode of the GT taskvar: the planner's plan,
    the GT vision (both rngs seeded alike), the motion planner with the JAX
    engine's weights; each step runs the model (one push_forward plan,
    restart on)."""
    jengine = jpipe.MotionPlannerEngine(mp_config_file)
    engine = pipe.MotionPlannerEngine(mp_config_file, device="cpu")
    engine.model.load_state_dict(params_from_jax(jengine.variables),
                                 strict=True)
    jembed = jpipe.ActionTextEmbedder()
    jembed._clip_failed = True          # the crc32 embedding, no CLIP model
    jp = jpipe.GroundtruthRobotPipeline(GT_CFG, motion_planner=jengine,
                                        text_embedder=jembed)
    p = pipe.GroundtruthRobotPipeline(GT_CFG, motion_planner=engine)
    jp.vision.rng, p.vision.rng = (np.random.RandomState(9),
                                   np.random.RandomState(9))
    task, var = TASKVAR.split("+")
    jcache = cache = None
    calls = 0
    real_predict = engine.predict

    def counted(*a):
        nonlocal calls
        calls += 1
        return real_predict(*a)
    engine.predict = counted
    for step in range(3):
        obs = synthetic_observation(20 + step, cameras=2, height=96,
                                    width=96)
        req = dict(task_str=task, variation=int(var), step_id=step,
                   obs_state_dict=obs, episode_id=0)
        out = p.predict(cache=cache, **req)
        jout = jp.predict(cache=jcache, **req)
        cache, jcache = out["cache"], jout["cache"]
        assert out["action"].shape == (8,)
        np.testing.assert_allclose(out["action"], jout["action"], atol=ATOL,
                                   rtol=0)
        assert cache["highlevel_step_id"] == jcache["highlevel_step_id"]
    assert calls == 3
    assert cache["highlevel_plans"] == jcache["highlevel_plans"]
    with pytest.raises(FileNotFoundError):     # no file: no seeded init
        pipe.MotionPlannerEngine(mp_config_file, checkpoint="mp.pt",
                                 device="cpu")
