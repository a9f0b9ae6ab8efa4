"""PyTorch port vs the JAX package: the released 3D-LOTUS++ RobotPipeline.

Both packages' RobotPipeline over one tiny motion planner (the JAX
engine's seeded weights carried to the port by convert.params_from_jax),
the crc32 action-name embedding, a pipeline seed and a fake VLM that
serves fixed objects and grounds them by caption (the JAX package's own
test does the same, tests/test_robot_pipeline.py), each package with its
own copy of the objects. An episode of a ground-truth plan runs through
both: a grasp of a drawer handle (its level cropped by the estimated
height range), a move of the grasped object whose cached trajectory steps
move the remembered cloud, a release, a grasp, a move to a target
variable matched to the remembered cloud by chamfer distance, a release
and the restart past the plan's end. Every action agrees within 1e-4 and
the plan state (step ids, grasped name, remembered clouds within 1e-4,
cached trajectory) is the same; with save_obs_outs both write the
episode's steps. Then the release config: build_pipeline raises, naming
the weights, without backends, and with the scripted detector and
segmenter of eval/synthetic_obs.py one step of the port's RobotPipeline
(its VLMPipeline included) equals the JAX one's.
"""
import copy
import os

import numpy as np
import pytest
import yaml

from robot3dlotus_tpu.eval import robot_pipeline as jpipe
from robot3dlotus_tpu.vlm import owlv2_detector as jowl
from robot3dlotus_tpu.vlm import pipeline as jvlm
from robot3dlotus_tpu.vlm import sam_segmentor as jsam
from robot3dlotus_tpu_torch.convert import params_from_jax
from robot3dlotus_tpu_torch.eval import robot_pipeline as pipe
from robot3dlotus_tpu_torch.eval import serving
from robot3dlotus_tpu_torch.eval.synthetic_obs import (
    OBJECT_ID, TARGET_ID, TASKVAR, ScriptedVLMBackend, synthetic_observation)
from robot3dlotus_tpu_torch.vlm.owlv2_detector import Owlv2ObjectDetector
from robot3dlotus_tpu_torch.vlm.pipeline import ObjectInfo, VLMPipeline
from robot3dlotus_tpu_torch.vlm.sam_segmentor import SAMSegmentor
from test_torch_port_motion_planner import mp_config_file  # noqa: F401

ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAN = """# taskvar: synthetic_task0+0
# query: do the task
a = grasp(object="bottom drawer handle")
move_grasped_object(target="out")
release()
b = grasp(object="cube")
move_grasped_object(target=a)
release()
"""
RELEASE_CFG = os.path.join(REPO, "robot3dlotus_tpu_torch", "configs",
                           "rlbench", "robot_pipeline.yaml")


class _FakeVLM:
    """Fixed objects; a query grounds the first object whose caption it
    holds, else the first uncaptioned one."""

    def __init__(self, objects):
        self.objects = objects

    def run(self, rgb_images, pcd_images, arm_links_info):
        return {"objects": self.objects}

    def ground_object_with_query(self, text, objects=None, return_sims=False):
        objects = objects or self.objects
        for i, o in enumerate(objects):
            if o.captions and o.captions[0] != "robot" and \
                    o.captions[0] in text:
                return (i, objects[i], [1.0]) if return_sims else \
                    (i, objects[i])
        for i, o in enumerate(objects):
            if not o.captions:
                return (i, objects[i], [0.5]) if return_sims else \
                    (i, objects[i])
        return (None, None, []) if return_sims else (None, None)


def _objects():
    rng = np.random.RandomState(3)

    def obj(center, caption=None, n=90, spread=0.02):
        xyz = (rng.randn(n, 3) * spread + center).astype(np.float32)
        return ObjectInfo(pcd_xyz=xyz, pcd_rgb=rng.randint(0, 255, (n, 3)),
                          captions=[caption] if caption else [])
    return [obj([0.2, 0.1, 0.85], "cube"),
            obj([0.35, -0.15, 0.95], "drawer handle", spread=0.06),
            obj([-0.25, 0.0, 1.0], "robot"),
            obj([0.45, 0.25, 0.86]), obj([0.05, -0.3, 0.84])]


@pytest.fixture(scope="module")
def engines(mp_config_file):  # noqa: F811
    jengine = jpipe.MotionPlannerEngine(mp_config_file)
    engine = pipe.MotionPlannerEngine(mp_config_file, device="cpu")
    engine.model.load_state_dict(params_from_jax(jengine.variables),
                                 strict=True)
    jembed = jpipe.ActionTextEmbedder()
    jembed._clip_failed = True          # the crc32 embedding, no CLIP model
    return jengine, engine, jembed


def _config(tmp_path, tag, restart=True):
    plan_file = tmp_path / "plan.txt"
    plan_file.write_text(PLAN)
    return {"llm_planner": {"use_groundtruth": True,
                            "gt_plan_file": str(plan_file)},
            "object_grounding": {"use_groundtruth": False},
            "motion_planner": {"config_file": None, "checkpoint": None,
                               "run_action_step": 3, "save_obs_outs": True,
                               "pred_dir": str(tmp_path / tag)},
            "pipeline": {"restart": restart, "seed": 11}}


def _same_state(got, want):
    assert got["highlevel_plans"] == want["highlevel_plans"]
    for k in ("highlevel_step_id", "highlevel_step_id_norelease",
              "grasped_obj_name"):
        assert got[k] == want[k], k
    assert set(got["ret_objs"]) == set(want["ret_objs"])
    for k, v in want["ret_objs"].items():
        np.testing.assert_allclose(got["ret_objs"][k], v, atol=ATOL, rtol=0)
    assert len(got["valid_actions"]) == len(want["valid_actions"])
    for a, b in zip(got["valid_actions"], want["valid_actions"]):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["prev_ee_pose"], want["prev_ee_pose"],
                               atol=ATOL, rtol=0)


def test_robot_pipeline_episode_matches_jax(engines, tmp_path):
    """The plan pointer is driven (in both caches alike) through every plan
    line and past the end, since with random weights the stop bit fires
    at random: after a move that cached trajectory steps the pointer moves
    on as the stop bit would, so the replayed steps move the grasped
    object's remembered cloud."""
    jengine, engine, jembed = engines
    jp = jpipe.RobotPipeline(_config(tmp_path, "jax"), motion_planner=jengine,
                             vlm_pipeline=_FakeVLM(_objects()),
                             text_embedder=jembed)
    p = pipe.RobotPipeline(_config(tmp_path, "port"), motion_planner=engine,
                           vlm_pipeline=_FakeVLM(_objects()), device="cpu")
    seen = dict.fromkeys(("zrange", "release", "replay_move", "target_var",
                          "restart"), 0)
    real_zrange = p._estimate_zrange

    def zrange(plan, task_str, objects):
        z = real_zrange(plan, task_str, objects)
        seen["zrange"] += z is not None
        return z
    p._estimate_zrange = zrange
    state = {"step": 0, "cache": None, "jcache": None}

    def request():
        obs = synthetic_observation(5 + state["step"], cameras=1, height=32,
                                    width=32)
        req = dict(task_str="synthetic_task0", variation=0,
                   step_id=state["step"], obs_state_dict=obs, episode_id=0,
                   instructions=["do the task"])
        out = p.predict(cache=state["cache"], **req)
        jout = jp.predict(cache=state["jcache"], **req)
        state["cache"], state["jcache"] = out["cache"], jout["cache"]
        assert out["action"].shape == (8,) and \
            np.isfinite(out["action"]).all()
        np.testing.assert_allclose(out["action"], jout["action"], atol=ATOL,
                                   rtol=0, err_msg=f"step {state['step']}")
        _same_state(state["cache"], state["jcache"])
        state["step"] += 1
        return out

    def point(plan_id):
        for c in (state["cache"], state["jcache"]):
            c["highlevel_step_id"] = plan_id

    def replay():
        while state["cache"]["valid_actions"]:
            c = state["cache"]
            moving = c["grasped_obj_name"] is not None and c["highlevel_plans"][
                c["highlevel_step_id"] - 1]["action"].startswith(
                    "move grasped object")
            before = c["ret_objs"].get(c["grasped_obj_name"])
            before = None if before is None else before.copy()
            request()
            if moving:
                seen["replay_move"] += 1
                assert not np.array_equal(
                    before, c["ret_objs"][c["grasped_obj_name"]])

    request()                                  # plan 0: grasp, z-range
    assert state["cache"]["grasped_obj_name"] == "a"
    replay()
    for _ in range(8):                         # plan 1: move it out
        point(1)
        request()
        if state["cache"]["valid_actions"]:
            point(2)                           # as if the stop bit fired
            replay()
            break
    point(2)                                   # release
    out = request()
    assert out["action"][7] == 1 and state["cache"]["grasped_obj_name"] is None
    seen["release"] += 1
    point(3)                                   # grasp the cube
    request()
    replay()
    point(4)                                   # move to the variable a
    assert state["cache"]["highlevel_plans"][4]["is_target_variable"]
    request()
    seen["target_var"] += 1
    replay()
    point(6)                                   # past the end: restart
    request()
    seen["restart"] += 1
    assert state["cache"]["highlevel_step_id"] <= 1 and \
        state["cache"]["grasped_obj_name"] == "a"
    assert all(seen.values()), seen
    files = sorted(os.listdir(os.path.join(
        str(tmp_path), "port", "obs_outs", "synthetic_task0+0", "0")))
    jfiles = sorted(os.listdir(os.path.join(
        str(tmp_path), "jax", "obs_outs", "synthetic_task0+0", "0")))
    assert files == jfiles and "0.npy" in files
    saved = np.load(os.path.join(str(tmp_path), "port", "obs_outs",
                                 "synthetic_task0+0", "0", "0.npy"),
                    allow_pickle=True).item()
    assert set(saved) == {"obs", "valid_actions"}


def test_motion_planner_input_matches_jax(engines, tmp_path):
    """prepare_motion_planner_input alone: a target variable matched by
    chamfer distance and a z-range crop give the same labels, points and
    normalisation, sampled from the same seeded RandomState."""
    jengine, engine, jembed = engines
    jp = jpipe.RobotPipeline(_config(tmp_path, "jax"), motion_planner=jengine,
                             vlm_pipeline=_FakeVLM(_objects()),
                             text_embedder=jembed)
    p = pipe.RobotPipeline(_config(tmp_path, "port"), motion_planner=engine,
                           vlm_pipeline=_FakeVLM(_objects()), device="cpu")
    obs = synthetic_observation(6, cameras=1, height=32, width=32)
    plan = {"action": "move grasped object", "object": "cube",
            "target": "a", "is_target_variable": True, "ret_val": None}
    objs = _objects()
    var = objs[3].pcd_xyz + 0.004
    args = (plan, obs["arm_links_info"], obs["gripper"])
    got, mani = p.prepare_motion_planner_input(
        copy.deepcopy(objs), *args, zrange=np.array([0.8, 0.9]),
        target_var_xyz=var)
    want, jmani = jp.prepare_motion_planner_input(
        copy.deepcopy(objs), *args, zrange=np.array([0.8, 0.9]),
        target_var_xyz=var)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    assert set(np.unique(got["pc_labels"])) == {0, 1, 2, 3}
    np.testing.assert_array_equal(mani["pcd_xyz"], jmani["pcd_xyz"])
    drawer = {"action": "grasp", "object": "bottom drawer handle",
              "target": None, "ret_val": "a"}
    np.testing.assert_array_equal(
        p._estimate_zrange(drawer, "open_drawer", objs),
        jp._estimate_zrange(drawer, "open_drawer", objs))


def test_release_config_builds_with_injected_backends(engines, tmp_path):
    """robot_pipeline.yaml: without backends build_pipeline raises naming
    the OWLv2 and SAM weights; with the scripted detector and segmenter
    one step of the port's RobotPipeline equals the JAX package's (its
    VLMPipeline over the same scripted backend)."""
    jengine, engine, jembed = engines
    with open(RELEASE_CFG) as f:
        cfg = yaml.safe_load(f)
    assert cfg["object_grounding"]["use_groundtruth"] is False
    with pytest.raises(RuntimeError, match="OWLv2.*SAM"):
        serving.build_pipeline(cfg, device="cpu", motion_planner=engine)
    no_llm = copy.deepcopy(cfg)
    no_llm["llm_planner"]["use_groundtruth"] = False
    with pytest.raises(RuntimeError, match="LLM planner"):
        serving.build_pipeline(no_llm, device="cpu", motion_planner=engine,
                               vlm_pipeline=_FakeVLM(_objects()))
    with open(RELEASE_CFG.replace("robot_pipeline.yaml",
                                  "robot_pipeline_gt.yaml")) as f:
        gt = serving.build_pipeline(yaml.safe_load(f), device="cpu",
                                    motion_planner=engine)
    assert isinstance(gt, pipe.GroundtruthRobotPipeline)

    obs = synthetic_observation(7, cameras=2, height=96, width=96)
    backend = ScriptedVLMBackend({OBJECT_ID: "red cube",
                                  TARGET_ID: "green square"})
    backend.register(obs)
    p = serving.build_pipeline(cfg, device="cpu", motion_planner=engine,
                               det=Owlv2ObjectDetector(backend=backend),
                               sam=SAMSegmentor(backend=backend))
    assert isinstance(p, pipe.RobotPipeline) and \
        isinstance(p.vlm_pipeline, VLMPipeline)

    class JaxDet:
        sqrt_num_patches = backend.sqrt_num_patches
        encode_images = staticmethod(backend.encode_images)
        encode_texts = staticmethod(backend.encode_texts)

        @staticmethod
        def post_process_objectness_detection(out, **kw):
            return jowl.post_process_objectness(
                out["objectness_logits"], out["pred_boxes"],
                sqrt_num_patches=backend.sqrt_num_patches, **kw)

    def jax_sam(images, boxes):
        res = []
        for r in backend(images, boxes):
            s, m = jsam.select_best_masks(r["scores"], r["masks"])
            res.append({"scores": s, "masks": m.astype(bool)})
        return res
    jp = jpipe.RobotPipeline(
        cfg, motion_planner=jengine, text_embedder=jembed,
        vlm_pipeline=jvlm.VLMPipeline(det=JaxDet(), sam=jax_sam))
    task, var = TASKVAR.split("+")
    req = dict(task_str=task, variation=int(var), step_id=0,
               obs_state_dict=obs, episode_id=0)
    out, jout = p.predict(**req), jp.predict(**req)
    np.testing.assert_allclose(out["action"], jout["action"], atol=ATOL,
                               rtol=0)
    _same_state(out["cache"], jout["cache"])
    assert out["cache"]["highlevel_plans"][0]["action"] == "push forward"
