"""PyTorch port vs the JAX package: the VLM grounding of 3D-LOTUS++.

Against the JAX functions on the same seeded inputs (no model weights and
no upstream checkout needed):
  * the OWLv2 post-processing (soft-NMS, objectness boxes) and SAM's
    best-of-3 mask, parametrised as tests/test_vlm_postprocess.py is, and
    equal bit for bit (both are the same numpy);
  * chamfer and nearest-pair distances (numpy float64 equal; the torch
    chamfer within 1e-5 of the jnp one) and farthest-point sampling (the
    same indices, with and without a validity mask);
  * VLMPipeline.run on a seeded 4-view tabletop with the scripted detector
    and segmenter of eval/synthetic_obs.py: the same detections, cleaned
    boxes and objects (captions, view and box ids, embeddings, points and
    colours exactly), then grounding and classification, and the
    Set-of-Mark images;
  * LLMTaskPlanner with a scripted chat backend: the same messages, plans,
    cache and height ranges.
The OWLv2 / SAM shells and SentenceSim raise, naming the weights, without
an injected backend.
"""
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from robot3dlotus_tpu.ops import chamfer as jchamfer
from robot3dlotus_tpu.ops import sampling as jsampling
from robot3dlotus_tpu.vlm import llm_planner as jllm
from robot3dlotus_tpu.vlm import owlv2_detector as jowl
from robot3dlotus_tpu.vlm import pipeline as jpipe
from robot3dlotus_tpu.vlm import sam_segmentor as jsam
from robot3dlotus_tpu.vlm import clip_encoder as jclip
from robot3dlotus_tpu_torch.eval.synthetic_obs import (
    OBJECT_ID, TARGET_ID, ScriptedVLMBackend, synthetic_observation)
from robot3dlotus_tpu_torch.ops import chamfer, sampling
from robot3dlotus_tpu_torch.vlm import clip_encoder, llm_planner
from robot3dlotus_tpu_torch.vlm import owlv2_detector as owl
from robot3dlotus_tpu_torch.vlm import pipeline as pipe
from robot3dlotus_tpu_torch.vlm import sam_segmentor as sam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = {OBJECT_ID: "red cube", TARGET_ID: "green square"}


def _random_boxes(rng, n, scale=1.0):
    xy = rng.rand(n, 2) * 0.6 * scale
    wh = (rng.rand(n, 2) * 0.35 + 0.02) * scale
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("sigma,thresh", [(0.5, 0.001), (0.2, 0.1)])
def test_soft_nms_equal_jax(seed, sigma, thresh):
    rng = np.random.RandomState(seed)
    boxes = _random_boxes(rng, 40, scale=960)
    scores = rng.rand(40).astype(np.float32)
    got = owl.soft_nms(boxes, scores, sigma=sigma, thresh=thresh)
    want = jowl.soft_nms(boxes, scores, sigma=sigma, thresh=thresh)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(got) > 0


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kw", [
    dict(threshold=0.1, max_size_ratio=0.8, use_nms=False),
    dict(threshold=0.1, min_size_ratio=0.002, max_size_ratio=0.6,
         max_return_topk=20, use_nms=True, nms_sigma=0.2, nms_thresh=0.1,
         target_sizes=(256, 256)),
    dict(threshold=0.999, min_return_topk=5, max_size_ratio=0.8),
])
def test_post_process_objectness_equal_jax(seed, kw):
    rng = np.random.RandomState(seed)
    B, P, sqrt_p = 2, 144, 12
    logits = rng.randn(B, P).astype(np.float32) * 2
    cxy = rng.rand(B, P, 2) * 0.8 + 0.1
    wh = rng.rand(B, P, 2) * 0.4 + 0.01
    pred = np.concatenate([cxy, wh], -1).astype(np.float32)
    got = owl.post_process_objectness(logits, pred, sqrt_num_patches=sqrt_p,
                                      **kw)
    want = jowl.post_process_objectness(logits, pred,
                                        sqrt_num_patches=sqrt_p, **kw)
    assert len(got) == len(want) == B
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    # the detector shell post-processes through the same function
    det = owl.Owlv2ObjectDetector(backend=None, sqrt_num_patches=sqrt_p)
    shell = det.post_process_objectness_detection(
        {"objectness_logits": logits, "pred_boxes": pred}, **kw)
    for g, s in zip(got, shell):
        assert all(np.array_equal(g[k], s[k]) for k in g)


def test_sam_best_of_three_equal_jax():
    rng = np.random.RandomState(5)
    scores = rng.rand(7, 3).astype(np.float32)
    masks = rng.rand(7, 3, 16, 16) > 0.5
    for g, w in zip(sam.select_best_masks(scores, masks),
                    jsam.select_best_masks(scores, masks)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_shells_raise_naming_weights(monkeypatch):
    det = owl.Owlv2ObjectDetector()
    with pytest.raises(RuntimeError, match="OWLv2.*weights"):
        det.encode_images(np.zeros((1, 8, 8, 3), np.uint8))
    with pytest.raises(RuntimeError, match="OWLv2.*weights"):
        det.encode_texts(["a cube"])
    with pytest.raises(RuntimeError, match="SAM.*weights"):
        sam.SAMSegmentor()(np.zeros((1, 8, 8, 3), np.uint8), [[]])
    with pytest.raises(RuntimeError, match="weights"):
        pipe.VLMPipeline().run(np.zeros((1, 8, 8, 3), np.uint8),
                               np.zeros((1, 8, 8, 3), np.float32),
                               synthetic_observation(0, 1, 8, 8)[
                                   "arm_links_info"])
    monkeypatch.setenv("SENTENCE_MODEL_PATH", "/nonexistent/minilm")
    with pytest.raises(RuntimeError, match="sentence"):
        llm_planner.SentenceSim()
    assert clip_encoder.get_prompts_from_label("red cube") == \
        jclip.get_prompts_from_label("red cube")


# ------------------------------------------------------- distances, FPS --

def _clouds(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(300, 3).astype(np.float32) * 0.1,
            rng.randn(200, 3).astype(np.float32) * 0.1 + 0.05)


@pytest.mark.parametrize("reduction", ["mean", "sum", "min"])
def test_chamfer_equal_jax(reduction):
    a, b = _clouds()
    assert chamfer.chamfer_distance_np(a, b, reduction) == \
        jchamfer.chamfer_distance_np(a, b, reduction)
    got = float(chamfer.chamfer_distance(torch.from_numpy(a),
                                         torch.from_numpy(b), reduction))
    want = float(jchamfer.chamfer_distance_jnp(jnp.asarray(a),
                                               jnp.asarray(b), reduction))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))
    assert chamfer.min_pair_distance_np(a, b) == \
        jchamfer.min_pair_distance_np(a, b)
    assert chamfer.chamfer_distance_np(a[:0], b) == np.inf


@pytest.mark.parametrize("masked", [False, True])
def test_farthest_point_sample_equal_jax(masked):
    a, _ = _clouds(3)
    a[17] = a[40]                 # a tie: the lowest index wins
    mask = np.ones(len(a), bool)
    if masked:
        mask[::3] = False
    got = sampling.farthest_point_sample(
        torch.from_numpy(a), 64, torch.from_numpy(mask) if masked else None,
        start=1)
    want = jsampling.farthest_point_sample(
        jnp.asarray(a), 64, jnp.asarray(mask) if masked else None, start=1)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    if masked:
        assert mask[got.numpy()].all()
    np.testing.assert_array_equal(
        sampling.farthest_point_sample_np(a, 32, start=5),
        jsampling.farthest_point_sample_np(a, 32, start=5))
    np.testing.assert_array_equal(
        sampling.farthest_point_sample_np(a, 32,
                                          rng=np.random.RandomState(2)),
        jsampling.farthest_point_sample_np(a, 32,
                                           rng=np.random.RandomState(2)))


# ---------------------------------------------------------- VLMPipeline --

class _JaxDet:
    """The scripted backend behind the JAX package's post-processing."""

    def __init__(self, backend):
        self.backend = backend
        self.sqrt_num_patches = backend.sqrt_num_patches

    def encode_images(self, images):
        return self.backend.encode_images(images)

    def encode_texts(self, texts):
        return self.backend.encode_texts(texts)

    def post_process_objectness_detection(self, out, **kw):
        return jowl.post_process_objectness(
            out["objectness_logits"], out["pred_boxes"],
            sqrt_num_patches=self.sqrt_num_patches, **kw)


def _jax_sam(backend):
    def segment(images, boxes):
        out = []
        for r in backend(images, boxes):
            if r is None:
                out.append(None)
                continue
            s, m = jsam.select_best_masks(r["scores"], r["masks"])
            out.append({"scores": s, "masks": m.astype(bool)})
        return out
    return segment


def _same(a, b, what):
    if isinstance(b, dict):
        assert set(a) == set(b), what
        for k in b:
            _same(a[k], b[k], f"{what}/{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif b is None:
        assert a is None, what
    elif isinstance(b, np.ndarray):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b), what
    else:
        assert a == b, what


def _objects_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("view_ids", "obj_ids", "captions", "boxes", "masks",
                  "image_class_embeds", "objectness_scores", "pcd_xyz",
                  "pcd_rgb"):
            _same(getattr(g, k), getattr(w, k), f"object {i} {k}")


@pytest.fixture(scope="module")
def scene():
    """The seeded 4-view scene through both packages' VLMPipeline."""
    obs = synthetic_observation(31, cameras=4, height=128, width=128)
    backend = ScriptedVLMBackend(NAMES)
    backend.register(obs)
    port = pipe.VLMPipeline(det=owl.Owlv2ObjectDetector(backend=backend),
                            sam=sam.SAMSegmentor(backend=backend))
    ref = jpipe.VLMPipeline(det=_JaxDet(backend), sam=_jax_sam(backend))
    args = (obs["rgb"], obs["pc"], obs["arm_links_info"])
    return obs, port, port.run(*args), ref, ref.run(*args)


def test_vlm_pipeline_run_equal_jax(scene):
    _, _, got, _, want = scene
    assert set(got) == set(want)
    for k in ("det_results", "sam_results", "cleaned_det_results",
              "cleaned_sam_results"):
        _same(got[k], want[k], k)
    _objects_equal(got["objects"], want["objects"])
    objs = got["objects"]
    captions = [o.captions[0] if o.captions else None for o in objs]
    # eight boxes found across the views, the arm apart; the table, the
    # wall and the gripper boxes were cleaned away
    assert captions.count(None) == 8 and "robot" in captions
    assert max(len(o.view_ids) for o in objs) == 4
    assert sum(len(d["boxes"]) for d in got["cleaned_det_results"]) < \
        sum(len(d["boxes"]) for d in got["det_results"])


def test_grounding_and_classification_equal_jax(scene):
    obs, port, got, ref, want = scene
    for text in ("red cube", "green square", "the blue bowl"):
        g = port.ground_object_with_query(text, return_sims=True)
        w = ref.ground_object_with_query(text, return_sims=True)
        assert g[0] == w[0] and g[2] == w[2], text
    texts = ["red cube", "green square", "table"]
    labels = port.classify_objects_with_queries(texts)
    assert labels == ref.classify_objects_with_queries(texts)
    assert port.classify_objects_with_queries(
        texts, add_robot_obstacle=False) == ref.classify_objects_with_queries(
        texts, add_robot_obstacle=False)
    # the named objects are the scene's: each holds the points of its id
    pc = np.concatenate([p.reshape(-1, 3) for p in obs["pc"]])
    sem = np.concatenate([s.reshape(-1) for s in obs["gt_mask"]])
    for sem_id, text in NAMES.items():
        best, obj = port.ground_object_with_query(text)
        centre = pc[sem == sem_id].mean(0)
        assert np.abs(obj.pcd_xyz.mean(0)[:2] - centre[:2]).max() < 0.03
        assert labels[best] == text


def test_som_images_and_captions_equal_jax(scene):
    obs, port, got, ref, want = scene
    g_imgs, g_n = port.prepare_som_images(obs["rgb"],
                                          got["cleaned_sam_results"])
    w_imgs, w_n = ref.prepare_som_images(obs["rgb"],
                                         want["cleaned_sam_results"])
    assert g_n == w_n and sum(g_n) > 0
    for g, w in zip(g_imgs, w_imgs):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.tobytes() == w.tobytes()
    model = lambda xyz, captions: f"{len(xyz)} points"  # noqa: E731
    objs = port.generate_3d_captions(got["objects"], model)
    robs = ref.generate_3d_captions(want["objects"], model)
    assert [getattr(o, "caption_3d", None) for o in objs] == \
        [getattr(o, "caption_3d", None) for o in robs]


# ------------------------------------------------------------ the planner --

class _Chat:
    """A scripted chat backend: records the messages, answers a plan or a
    height range."""

    def __init__(self):
        self.calls = []

    def __call__(self, messages, temperature=0.0):
        self.calls.append((messages, temperature))
        if "height range" in messages[-1]["content"]:
            return "[0.1, 0.25]\n# done"
        return ('# plan\nblock = grasp(object="red cube")\n'
                'move_grasped_object(target="green square")\nrelease()')


def _planners(tmp_path, **kw):
    args = dict(prompt_dir=os.path.join(REPO, "prompts", "rlbench"),
                asset_dir=os.path.join(REPO, "assets"), topk=5, seed=3, **kw)
    a, b = _Chat(), _Chat()
    return (llm_planner.LLMTaskPlanner(backend=a, **args), a,
            jllm.LLMTaskPlanner(backend=b, **args), b)


def test_llm_planner_equal_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("SENTENCE_MODEL_PATH", raising=False)
    port, pc, ref, rc = _planners(tmp_path)
    assert len(port.trn_instrs) > 50
    np.testing.assert_array_equal(port.trn_embeds, ref.trn_embeds)
    for q, ctx in (("slide the block onto the green target", None),
                   ("Push the red button.", ["red button", "table"])):
        got, want = port(q, context=ctx), ref(q, context=ctx)
        assert got == want
        assert got[1] == ['block = grasp(object="red cube")',
                          'move_grasped_object(target="green square")',
                          "release()"]
    assert [m for m, _ in pc.calls] == [m for m, _ in rc.calls]
    msgs = pc.calls[0][0]
    assert [m["role"] for m in msgs] == ["system", "user", "assistant",
                                         "user"]
    assert msgs[1]["content"].count("# query:") == 5
    assert msgs[3]["content"] == \
        "# query: slide the block onto the green target."
    n = len(pc.calls)
    # cached under the query as prompted (with its full stop)
    assert port("slide the block onto the green target.") == \
        ref("slide the block onto the green target.")
    assert len(pc.calls) == n
    np.testing.assert_array_equal(
        port.estimate_height_range("bottom drawer", 0.3),
        ref.estimate_height_range("bottom drawer", 0.3))
    assert pc.calls[-1][0] == rc.calls[-1][0]


def test_llm_planner_cache_file_equal_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("SENTENCE_MODEL_PATH", raising=False)
    cache = tmp_path / "plans.jsonl"
    with open(cache, "w") as f:
        for instr, res in (("open the drawer", "# c\nx = grasp(object="
                            '"drawer handle")\nmove_grasped_object(target='
                            '"out")'), ("press it", "push_down(object="
                                                    '"button")')):
            f.write(json.dumps({"instruction": instr, "results": res}) + "\n")
    port = llm_planner.LLMTaskPlanner(cache_file=str(cache))
    ref = jllm.LLMTaskPlanner(cache_file=str(cache))
    assert port.cache == ref.cache
    assert port("open the drawer") == ref("open the drawer")
    with pytest.raises(RuntimeError, match="no chat backend"):
        port("close the drawer")
    assert port.estimate_height_range("top shelf", 0.5).tolist() == \
        ref.estimate_height_range("top shelf", 0.5).tolist()
