"""The port's serving preprocess against the JAX package's, on the CPU.

Native (robot3dlotus_tpu_torch/native, built with g++ into build/native):
voxelize_trace and crop_voxelize_trace bit-equal to the JAX native and
numpy paths (dense and hash engines), neighbor_map_dense bit-equal to the
JAX build_neighbor_map_np, a broken contract raises. voxelize_fixed: vmask,
first and overflow exact, means within 1e-6, out-of-extent points and
overflowing capacity included. device_preprocess fed the JAX program's own
uniform draws: pc_ft, centroid, radius and ee within 1e-6, mask and count
exact. make_obs_to_action on params_from_jax weights against the JAX one:
the action within 1e-4, count and overflow exact. The Actioner: its host
preprocess (now through the native crop + voxelizer) bit-equal to the numpy
chain it replaced; the fused path (device_preprocess=True) against the host
path on a sparse cloud at the JAX test's bars, its overflow warning, its
tiny-cloud guard, predict_batch as sequential predicts, and no fused
request without a card unless device='cpu'.
"""
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import yaml

from robot3dlotus_tpu import native as jnative
from robot3dlotus_tpu.models.simple_policy import SimplePolicyTPU
from robot3dlotus_tpu.ops import eval_preprocess as jprep
from robot3dlotus_tpu.ops import voxel as jvoxel
from robot3dlotus_tpu.ops.sparse_conv import (build_neighbor_map_np,
                                              stencil_offsets)
from robot3dlotus_tpu.train.datasets.store import SyntheticStore
from robot3dlotus_tpu.utils.robot_box import RobotBox as JRobotBox
from robot3dlotus_tpu_torch import native
from robot3dlotus_tpu_torch.configs.rlbench.constants import \
    get_robot_workspace
from robot3dlotus_tpu_torch.convert import params_from_jax
from robot3dlotus_tpu_torch.eval.actioner import Actioner
from robot3dlotus_tpu_torch.eval.synthetic_obs import synthetic_observation
from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.ops import eval_preprocess as prep
from robot3dlotus_tpu_torch.ops.voxel import (voxelize_fixed,
                                              voxelize_pcd_np,
                                              workspace_mask_np)
from robot3dlotus_tpu_torch.utils.robot_box import RobotBox
from test_torch_port_policy import ACT, MODEL_CFG, PTV3, _perturb

WS = get_robot_workspace()


def _clouds():
    rng = np.random.RandomState(0)
    grid = np.round(rng.uniform(-0.3, 0.6, (3000, 3)), 2)   # duplicates
    return {
        "workspace": (rng.uniform([-0.4, -0.6, 0.7], [0.8, 0.6, 1.6],
                                  (20000, 3))).astype(np.float32),
        "on_edges": (grid + rng.choice([0, 0.005], grid.shape)).astype(
            np.float32),
        "wide": rng.uniform(-20, 20, (5000, 3)).astype(np.float32),  # hash
    }


@pytest.mark.parametrize("name", ["workspace", "on_edges", "wide"])
def test_native_voxelize_bit_equal_jax_native_and_numpy(name, monkeypatch):
    xyz = _clouds()[name]
    got = native.voxelize_trace_native(xyz, 0.01)
    want = jnative.voxelize_trace_native(xyz, 0.01)
    for g, w, p in zip(got, want, voxelize_pcd_np(xyz, 0.01)):
        assert g.dtype == w.dtype == p.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)
    monkeypatch.setattr(jnative, "voxelize_trace_native", lambda *a: None)
    for g, w in zip(got, jvoxel.voxelize_pcd_np(xyz, 0.01)):  # JAX numpy
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("rm_table", [True, False])
@pytest.mark.parametrize("name", ["workspace", "on_edges"])
def test_native_crop_voxelize_bit_equal(name, rm_table):
    xyz = _clouds()[name]
    means, first, keep = native.crop_voxelize_trace_native(xyz, 0.01, WS,
                                                           rm_table)
    jm, jf, jk = jnative.crop_voxelize_trace_native(xyz, 0.01, WS, rm_table)
    np.testing.assert_array_equal(keep, jk)
    np.testing.assert_array_equal(means, jm)
    np.testing.assert_array_equal(first, jf)
    mask = workspace_mask_np(xyz, WS, rm_table=rm_table)
    np.testing.assert_array_equal(keep, mask)
    pm, pf = voxelize_pcd_np(xyz[mask], 0.01)
    np.testing.assert_array_equal(means, pm)
    np.testing.assert_array_equal(first, np.nonzero(mask)[0][pf])


def test_native_rejects_broken_contracts():
    with pytest.raises(ValueError, match="non-finite"):
        native.voxelize_trace_native(
            np.array([[0, 0, 0], [np.nan, 0, 0]], np.float32), 0.01)
    with pytest.raises(ValueError, match="2\\^21"):
        native.voxelize_trace_native(
            np.array([[0, 0, 0], [1e5, 0, 0]], np.float32), 0.01)
    grid = np.zeros((1, 4, 3), np.int32)
    grid[0, 1] = 40
    with pytest.raises(ValueError, match="contract"):
        native.neighbor_map_dense_native(grid, np.array([4], np.int32),
                                         stencil_offsets(3), 32)


@pytest.mark.parametrize("kernel,extent", [(3, 64), (5, 128)])
def test_native_neighbor_map_bit_equal_jax(kernel, extent):
    rng = np.random.RandomState(kernel)
    B, N = 3, 400
    grid = rng.randint(0, extent, (B, N, 3)).astype(np.int32)
    grid[:, 100:140] = rng.randint(0, 6, (B, 40, 3))     # dense corner
    grid[:, 10] = grid[:, 11]                            # duplicates
    grid[:, 20] = extent - 1                             # boundary
    counts = np.array([N, 250, 0], np.int32)
    offs = stencil_offsets(kernel).astype(np.int32)
    got = native.neighbor_map_dense_native(grid, counts, offs, extent)
    want = build_neighbor_map_np(grid, counts, kernel, 10, extent=extent)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got.astype(np.int32), want)
    np.testing.assert_array_equal(
        got, jnative.neighbor_map_dense_native(grid, counts, offs, extent))


# ------------------------------------------------------ voxelize_fixed --

@pytest.mark.parametrize("capacity,voxel", [(16384, 0.01), (300, 0.01),
                                            (8192, 0.001)])
def test_voxelize_fixed_equal_jax(capacity, voxel):
    rng = np.random.RandomState(1)
    xyz = rng.uniform(-0.4, 0.6, (12000, 3)).astype(np.float32)
    xyz[:3000] = np.round(xyz[:3000], 2)
    mask = rng.rand(12000) > 0.25
    got = voxelize_fixed(torch.from_numpy(xyz), torch.from_numpy(mask),
                         voxel, capacity)
    want = jvoxel.voxelize_fixed_jnp(jnp.asarray(xyz), jnp.asarray(mask),
                                     voxel, capacity)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-6, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # capacity 300 drops voxels; voxel 1 mm puts points past 1024 cells
    assert int(got[3]) > 0 if capacity == 300 or voxel < 0.01 else \
        int(got[3]) == 0


# ---------------------------------------------------- device preprocess --

def _raw_obs(points, seed=0, cap=16384):
    st = SyntheticStore(points_per_step=points, seed=seed)
    ep = st.get(st.taskvars()[0], st.episodes("x")[0])
    xyz = np.asarray(ep["xyz"][0], np.float32)
    rgb = np.asarray(ep["rgb"][0], np.float32)
    arm = ({k: np.asarray(v[0]) for k, v in ep["bbox_info"].items()},
           {k: np.asarray(v[0]) for k, v in ep["pose_info"].items()})
    raw_xyz = np.zeros((cap, 3), np.float32)
    raw_rgb = np.zeros((cap, 3), np.float32)
    raw_xyz[:len(xyz)], raw_rgb[:len(rgb)] = xyz, rgb
    return raw_xyz, raw_rgb, len(xyz), arm


@pytest.mark.parametrize("xyz_norm,xyz_shift", [(False, "center"),
                                                (True, "center"),
                                                (True, "gripper")])
@pytest.mark.parametrize("num_points", [256, 4096])
def test_device_preprocess_with_jax_draws(num_points, xyz_norm, xyz_shift):
    raw_xyz, raw_rgb, n, arm = _raw_obs(6000)
    obb = jprep.obb_params_np(JRobotBox(arm, keep_gripper=True))
    assert all(np.array_equal(v, prep.obb_params_np(
        RobotBox(arm, keep_gripper=True))[k]) for k, v in obb.items())
    valid = np.arange(len(raw_xyz)) < n
    ee = np.asarray([0.3, 0, 1.0, 0, 0, 0, 1, 1], np.float32)
    V = 4096
    key = jax.random.PRNGKey(7)
    kw = dict(workspace=WS, num_points=num_points, voxel_size=0.01,
              vox_capacity=V, xyz_norm=xyz_norm, xyz_shift=xyz_shift)
    want = jprep.device_preprocess(
        jnp.asarray(raw_xyz), jnp.asarray(raw_rgb), jnp.asarray(valid),
        *(jnp.asarray(obb[k]) for k in ("obb_rot", "obb_off", "obb_half")),
        jnp.asarray(ee), key, **kw)
    draws = np.array(jax.random.uniform(key, (V,)))
    t = torch.from_numpy
    got = prep.device_preprocess(
        t(raw_xyz), t(raw_rgb), t(valid),
        *(t(obb[k]) for k in ("obb_rot", "obb_off", "obb_half")), t(ee),
        t(draws), **kw)
    names = ["pc_ft", "mask", "count", "centroid", "radius", "ee",
             "vox_overflow"]
    for name, g, w in zip(names, got, want):
        if name in ("mask", "count", "vox_overflow"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=0, err_msg=name)
    count = int(got[2])
    assert (count == num_points) == (num_points == 256), count


# ----------------------------------------------------- fused program --

N_FUSED, V_FUSED = 256, 2048
FUSED_PTV3 = dict(PTV3, stage_caps=[N_FUSED] * 3)
DATA_CFG = dict(rm_table=True, rm_robot="box_keep_gripper",
                xyz_shift="center", xyz_norm=False, use_height=True)


@pytest.fixture(scope="module")
def fused_pair():
    """(JAX fused fn, its variables, the port's fused fn) on one set of
    weights."""
    jmodel = SimplePolicyTPU(ptv3_cfg=dict(FUSED_PTV3, attn_impl="xla",
                                           conv_impl="xla"),
                             act_cfg=ACT, variant="ca")
    key = jax.random.PRNGKey(0)
    b = {"pc_fts": jnp.zeros((1, N_FUSED, 7)),
         "pc_mask": jnp.ones((1, N_FUSED), bool),
         "pc_counts": jnp.full((1,), N_FUSED, jnp.int32),
         "txt_embeds": jnp.zeros((1, 4, 64)),
         "txt_mask": jnp.ones((1, 4), bool)}
    variables = jax.jit(lambda bb: jmodel.init(
        {"params": key, "dropout": key, "shuffle": key}, bb,
        deterministic=True))(b)
    variables = _perturb(jax.tree_util.tree_map(np.asarray, dict(variables)))
    jfn = jprep.make_obs_to_action(jmodel, ACT, DATA_CFG, WS, N_FUSED,
                                   vox_capacity=V_FUSED)
    model = build_model(dict(MODEL_CFG, ptv3_config=dict(
        FUSED_PTV3, assume_sorted=True)), device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    model.eval()
    pfn = prep.make_obs_to_action(model, ACT, DATA_CFG, WS, N_FUSED,
                                  vox_capacity=V_FUSED)
    return jfn, variables, pfn


@pytest.mark.parametrize("points,seed", [(6000, 0), (1500, 2)])
def test_make_obs_to_action_equal_jax(fused_pair, points, seed):
    jfn, variables, pfn = fused_pair
    raw_xyz, raw_rgb, n, arm = _raw_obs(points, seed=seed)
    obb_vec = prep.obb_vector(prep.obb_params_np(
        RobotBox(arm, keep_gripper=True)))
    txt = np.random.RandomState(5).randn(4, 64).astype(np.float32)
    ee = np.asarray([0.3, 0, 1.0, 0, 0, 0, 1, 1], np.float32)
    step_ee_key = np.concatenate([[0.0], ee, [3.0]]).astype(np.float32)
    want = np.asarray(jfn(variables, jnp.asarray(raw_xyz),
                          jnp.asarray(raw_rgb), np.int32(n),
                          jnp.asarray(obb_vec), jnp.asarray(txt),
                          jnp.ones(4, bool), jnp.asarray(step_ee_key)))
    draws = np.array(jax.random.uniform(jax.random.PRNGKey(3), (V_FUSED,)))
    t = torch.from_numpy
    got = pfn(t(raw_xyz), t(raw_rgb), n, t(obb_vec), t(txt),
              torch.ones(4, dtype=torch.bool), t(step_ee_key[:9]),
              t(draws)).numpy()
    assert got.shape == (10,) and got[8] > 10
    np.testing.assert_array_equal(got[8:], want[8:])       # count, overflow
    np.testing.assert_allclose(got[:8], want[:8], atol=1e-4, rtol=0)


# ------------------------------------------------------------ Actioner --

def _write_config(tmp_path, num_points):
    model = dict(MODEL_CFG, ptv3_config=dict(PTV3,
                                             stage_caps=[num_points] * 3))
    cfg = {"TRAIN_DATASET": {"num_points": num_points, "rm_robot":
                             "box_keep_gripper", "rm_table": True,
                             "xyz_shift": "center", "use_height": True},
           "MODEL": model}
    path = os.path.join(tmp_path, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _numpy_chain(a, xyz, rgb, ee_pose, arm_links_info):
    """The Actioner's host preprocess as it was before the native crop:
    workspace_mask_np, then voxelize_pcd_np on the cropped cloud."""
    xyz = np.ascontiguousarray(xyz.reshape(-1, 3), np.float32)
    rgb = rgb.reshape(-1, 3).astype(np.float32)
    m = workspace_mask_np(xyz, a.WORKSPACE, rm_table=True)
    xyz, rgb = xyz[m], rgb[m]
    xyz, first = voxelize_pcd_np(xyz, 0.01)
    rgb = rgb[first]
    keep = ~RobotBox(arm_links_info, keep_gripper=True).point_mask(xyz)
    xyz, rgb = xyz[keep], rgb[keep]
    if len(xyz) > a.num_points:
        idxs = a.rng.choice(len(xyz), a.num_points, replace=False)
        xyz, rgb = xyz[idxs], rgb[idxs]
    height = xyz[:, 2] - a.TABLE_HEIGHT
    centroid = xyz.mean(0)
    ee = np.asarray(ee_pose, np.float32).copy()
    ee[:3] = ee[:3] - centroid
    pc_ft = np.concatenate([xyz - centroid, (rgb / 255.0) * 2 - 1,
                            height[:, None]], 1)
    return a._presort(pc_ft.astype(np.float32)), centroid, 1.0, ee


@pytest.mark.parametrize("num_points", [128, 1 << 20])
def test_process_point_clouds_unchanged_bit_for_bit(tmp_path, num_points):
    a = Actioner(_write_config(tmp_path, 128), device="cpu")
    a.num_points = num_points          # 128: subsampled; 2^20: all kept
    obs = synthetic_observation(4, cameras=2, height=64, width=64)
    args = (np.stack(obs["pc"], 0), np.stack(obs["rgb"], 0))
    kw = dict(ee_pose=obs["gripper"], arm_links_info=obs["arm_links_info"])
    a.rng = np.random.default_rng(9)
    got = a.process_point_clouds(*args, **kw)
    a.rng = np.random.default_rng(9)
    want = _numpy_chain(a, *args, **kw)
    assert len(got[0]) == min(num_points, len(want[0])) and \
        len(got[0]) > 100
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert set(a.prep_ms) == {"crop_voxelize", "robot_box", "subsample",
                              "presort"}


def _sparse_payload():
    """A sparse tabletop: few enough voxels that neither path subsamples."""
    obs = synthetic_observation(6, cameras=1, height=32, width=32)
    return {"task_str": "close_jar", "variation": 0, "step_id": 0,
            "obs_state_dict": obs}


def test_fused_predict_matches_host_predict(tmp_path):
    cfg = _write_config(tmp_path, 1024)
    host = Actioner(cfg, device="cpu", seed=1)
    fused = Actioner(cfg, device="cpu", seed=1, device_preprocess=True,
                     vox_capacity=2048)
    payload = _sparse_payload()
    pc_ft = host._host_prep("close_jar", 0, payload["obs_state_dict"],
                            None)[1]
    assert 10 < len(pc_ft) < 1024
    want = host.predict(**payload)["action"]
    got = fused.predict(**payload)["action"]
    np.testing.assert_allclose(got[:3], want[:3], atol=2e-4, err_msg="pos")
    np.testing.assert_allclose(got[3:7], want[3:7], atol=1e-4,
                               err_msg="quat")
    assert got[7] == want[7]
    # predict_batch: fused predicts one after another, the same draws
    payloads = [payload, dict(payload, variation=1)]
    fused.draws.manual_seed(4)
    seq = [fused.predict(**p)["action"] for p in payloads]
    fused.draws.manual_seed(4)
    bat = [o["action"] for o in fused.predict_batch(payloads)]
    for s, b in zip(seq, bat):
        np.testing.assert_array_equal(s, b)


def test_fused_overflow_is_logged_and_tiny_clouds_give_zero(tmp_path,
                                                            caplog):
    cfg = _write_config(tmp_path, 128)
    a = Actioner(cfg, device="cpu", device_preprocess=True, vox_capacity=128)
    obs = synthetic_observation(4, cameras=2, height=64, width=64)
    with caplog.at_level("WARNING", logger="robot3dlotus_tpu_torch.eval"):
        action = a.predict(task_str="close_jar", variation=0,
                           obs_state_dict=obs)["action"]
    assert "fused voxelizer dropped" in caplog.text
    assert action.shape == (8,) and np.isfinite(action).all()
    away = dict(obs, pc=[p + np.float32(10.0) for p in obs["pc"]])
    zero = a.predict(task_str="close_jar", variation=0,
                     obs_state_dict=away)["action"]
    np.testing.assert_array_equal(zero, a._zero_action())
    with pytest.raises(ValueError, match="vox_capacity"):
        Actioner(cfg, device="cpu", device_preprocess=True,
                 vox_capacity=64).predict(task_str="close_jar", variation=0,
                                          obs_state_dict=obs)


def test_fused_request_needs_a_card_unless_cpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    cfg = _write_config(tmp_path, 128)
    monkeypatch.setenv("ROBOT3DLOTUS_DEVICE_PREPROCESS", "1")
    monkeypatch.setenv("ROBOT3DLOTUS_VOX_CAPACITY", "512")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Actioner(cfg)
    a = Actioner(cfg, device="cpu")
    assert a.device_preprocess and a.vox_capacity == 512
