"""PyTorch port vs the JAX package: the whole keystep-policy slice.

SimplePolicyTPU(variant='ca') on the exact XLA paths, with JAX-initialised
(and perturbed) variables carried across by convert.params_from_jax, against
the port's SimplePolicy on the same numpy batch: pos/rot/open logits to
1e-4 and the decoded (B, 8) action, both through the entry sort and with
assume_sorted on the presorted batch. Then the Actioner's host
preprocessing (bit-equal to the JAX Actioner's) and predict_batch against
sequential predict. One JAX model build serves the module.
"""
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import yaml

from robot3dlotus_tpu.eval.actioner import Actioner as JaxActioner
from robot3dlotus_tpu.models.simple_policy import (SimplePolicyTPU,
                                                   decode_actions as jdecode)
from robot3dlotus_tpu_torch.convert import params_from_jax
from robot3dlotus_tpu_torch.eval.actioner import Actioner
from robot3dlotus_tpu_torch.eval.synthetic_obs import synthetic_observation
from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.models.simple_policy import decode_actions

ATOL = 1e-4

PTV3 = {
    "in_channels": 7, "orders": ["z", "z-trans", "hilbert", "hilbert-trans"],
    "stride": [2, 2], "enc_depths": [1, 1, 1], "enc_channels": [16, 32, 32],
    "enc_num_head": [2, 2, 4], "enc_patch_size": [16, 16, 16],
    "dec_depths": [1, 1], "dec_channels": [16, 32], "dec_num_head": [2, 2],
    "dec_patch_size": [16, 16], "qkv_bias": True, "qk_norm": True,
    "attn_drop": 0.1, "proj_drop": 0.1, "drop_path": 0.0,
    "shuffle_orders": True, "serial_depth": 7, "stem_kernel": 5,
    "stage_caps": [128, 80, 48],
}
ACT = {
    "voxel_size": 0.01, "context_channels": 32, "txt_ft_size": 64,
    "use_ee_pose": False, "use_step_id": False, "reduce": "max",
    "dim_actions": 7, "pos_pred_type": "heatmap_disc",
    "pos_heatmap_temp": 0.1, "rot_pred_type": "euler_disc", "dropout": 0.2,
    "pos_bins": 5, "pos_bin_size": 0.01, "best_disc_pos": "max",
    "euler_resolution": 5,
}
MODEL_CFG = {"model_class": "SimplePolicyPTV3CA", "ptv3_config": PTV3,
             "action_config": ACT}


def _batch(seed=0, B=2, N=128, T=4):
    rng = np.random.RandomState(seed)
    counts = np.array([N, N - 27][:B], np.int32)
    mask = np.arange(N)[None] < counts[:, None]
    pc = rng.uniform(-0.3, 0.3, (B, N, 7)).astype(np.float32) * \
        mask[..., None]
    txt = rng.randn(B, T, 64).astype(np.float32)
    tmask = np.ones((B, T), bool)
    tmask[0, 3:] = False
    return {"pc_fts": pc, "pc_mask": mask, "pc_counts": counts,
            "txt_embeds": txt, "txt_mask": tmask}


def _perturb(variables, seed=1):
    """Random biases, norm scales and BN statistics on top of the JAX init,
    so every converted leaf moves the output."""
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


@pytest.fixture(scope="module")
def jax_policy():
    cfg = dict(PTV3, attn_impl="xla", conv_impl="xla")
    model = SimplePolicyTPU(ptv3_cfg=cfg, act_cfg=ACT, variant="ca")
    key = jax.random.PRNGKey(0)
    b = {k: jnp.asarray(v) for k, v in _batch().items()}
    variables = jax.jit(lambda bb: model.init(
        {"params": key, "dropout": key, "shuffle": key}, bb,
        deterministic=True))(b)
    variables = _perturb(jax.tree_util.tree_map(np.asarray,
                                                dict(variables)))

    @jax.jit
    def run(v, bb):
        p = model.apply(v, bb, deterministic=True)
        return ({k: p[k] for k in ("pos", "rot", "open", "sort0")},
                jdecode(p, ACT))

    return variables, run


def _port_model(variables, assume_sorted):
    cfg = dict(MODEL_CFG, ptv3_config=dict(PTV3, assume_sorted=assume_sorted))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model


def _compare(model, batch, ref):
    preds_ref, act_ref = ref
    with torch.inference_mode():
        preds = model({k: torch.from_numpy(v) for k, v in batch.items()})
        act = decode_actions(preds, ACT).numpy()
    for k in ("pos", "rot", "open"):
        np.testing.assert_allclose(preds[k].numpy(), np.asarray(preds_ref[k]),
                                   atol=ATOL, rtol=0, err_msg=k)
    # the seed's argmax margins exceed the tolerance, so the bins agree
    pos = np.asarray(preds_ref["pos"]).reshape(2, 3, -1)
    top2 = np.sort(pos, -1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 2 * ATOL
    np.testing.assert_array_equal(preds["pos"].reshape(2, 3, -1).argmax(-1),
                                  pos.argmax(-1))
    np.testing.assert_array_equal(preds["rot"].argmax(1).numpy(),
                                  np.asarray(preds_ref["rot"]).argmax(1))
    np.testing.assert_allclose(act, np.asarray(act_ref), atol=ATOL, rtol=0)


def test_policy_entry_sort_matches_jax(jax_policy):
    variables, run = jax_policy
    batch = _batch()
    ref = run(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    _compare(_port_model(variables, False), batch, ref)


def test_policy_assume_sorted_matches_jax(jax_policy):
    """The presorted batch (each cloud in its stage-0 frame) through the
    port's assume_sorted backbone vs the JAX backbone on the same batch."""
    variables, run = jax_policy
    batch = _batch()
    preds, _ = run(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    sort0 = np.asarray(preds["sort0"])
    batch["pc_fts"] = np.take_along_axis(batch["pc_fts"], sort0[..., None],
                                         axis=1)
    ref = run(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_array_equal(np.asarray(ref[0]["sort0"]),
                                  np.broadcast_to(np.arange(128), (2, 128)))
    _compare(_port_model(variables, True), batch, ref)


def _write_config(tmp_path, num_points=128):
    # stage caps that cannot overflow at any point bucket, so a cloud gives
    # the same action in its own bucket and in a batch's larger one
    model = dict(MODEL_CFG, ptv3_config=dict(PTV3, stage_caps=[128] * 3))
    cfg = {"TRAIN_DATASET": {"num_points": num_points, "rm_robot":
                             "box_keep_gripper", "rm_table": True,
                             "xyz_shift": "center", "use_height": True},
           "MODEL": model}
    path = os.path.join(tmp_path, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_actioner_host_preprocess_bit_equal(tmp_path):
    """process_point_clouds + _presort of the port against the JAX
    Actioner's, on a cloud that needs no subsample (numpy parts only: the
    JAX side runs without building its model)."""
    port = Actioner(_write_config(tmp_path), device="cpu")
    port.num_points = 1 << 20
    ref = JaxActioner.__new__(JaxActioner)
    for k in ("data_cfg", "act_cfg", "WORKSPACE", "TABLE_HEIGHT",
              "num_points", "real_robot", "_presort_cfg"):
        setattr(ref, k, getattr(port, k))
    obs = synthetic_observation(3, cameras=2, height=64, width=64)
    args = (np.stack(obs["pc"], 0), np.stack(obs["rgb"], 0))
    kw = dict(ee_pose=obs["gripper"], arm_links_info=obs["arm_links_info"])
    got, want = port.process_point_clouds(*args, **kw), \
        ref.process_point_clouds(*args, **kw)
    assert got[0].shape[0] > 200
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_predict_batch_matches_sequential_predict(tmp_path):
    """Three clouds that land in two point buckets, one batched forward
    against three single ones (same subsample draws: the rng is reseeded)."""
    a = Actioner(_write_config(tmp_path), device="cpu")
    sizes = [(8, 10), (24, 24), (40, 24)]   # 44 points; 302, 510 -> 128
    payloads = [{"task_str": "close_jar", "variation": v, "step_id": 0,
                 "obs_state_dict": synthetic_observation(
                     10 + v, cameras=1, height=h, width=w)}
                for v, (h, w) in enumerate(sizes)]
    a.rng = np.random.default_rng(5)
    seq = [a.predict(**p)["action"] for p in payloads]
    a.rng = np.random.default_rng(5)
    bat = [o["action"] for o in a.predict_batch(payloads)]
    for s, b in zip(seq, bat):
        assert s.shape == (8,) and np.isfinite(s).all()
        np.testing.assert_allclose(b, s, atol=1e-5, rtol=0)


def test_instruction_embeddings_match_jax(tmp_path):
    """The synthetic per-taskvar embedding (crc32-seeded RandomState) and a
    precomputed instr_embed_file, against the JAX Actioner's lookup."""
    table = {"open the jar": np.random.RandomState(0).randn(5, 64)
             .astype(np.float32)}
    emb_file = os.path.join(tmp_path, "embeds.npy")
    np.save(emb_file, table)
    synth = Actioner(_write_config(tmp_path), device="cpu")
    loaded = Actioner(_write_config(tmp_path), device="cpu",
                      cli_opts=["TRAIN_DATASET.instr_embed_file", emb_file])
    for port in (synth, loaded):
        ref = JaxActioner.__new__(JaxActioner)
        ref.data_cfg, ref.act_cfg = port.data_cfg, port.act_cfg
        ref.instr_embeds = dict(port.instr_embeds)
        instr = "open the jar" if port is loaded else "do the task"
        got = port._encode_instruction(instr, taskvar="close_jar+3")
        want = ref._encode_instruction(instr, taskvar="close_jar+3")
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, table["open the jar"])
