"""Closed-loop evaluation and HTTP serving of the PyTorch port against the
JAX package, on the CPU.

The episodes: a seeded synthetic reach store written by the port's
LmdbWriterStore (2 taskvars x 2 episodes of 3 keysteps, clouds of at most
120 points, under the 128-point capacity, so no subsample draw differs).
The weights: JAX-initialised, perturbed variables of the tiny policy of
test_torch_port_train_step.py in <expr>/ckpts/model_step_1.msgpack (the
port loads them through convert.params_from_jax).

  * In process (queue.Queue and threads): the JAX producer_fn /
    consumer_fn with the JAX Actioner, and the port's with its Actioner,
    over the same ReplayEnv episodes: identical results rows, every
    step's action within 1e-4 (the policy tests' bar);
    MicrostepReplayActioner through both gives identical rows with sr = 1,
    as does the port's evaluate_microsteps.
  * consumer_fn's batching, fallback, 3-strike and 8-error behaviour on
    fake actioners: the port's as the JAX one's.
  * eval_simple_policy_server.main spawned on the CPU (--device cpu): the
    JAX layout of results.jsonl, a taskvar already there skipped, a second
    run with nothing to do; eval_robot_pipeline_server.main with the GT
    pipeline: its preds-llm_gt-og_gt_coarse layout.
  * The HTTP wire: a body packed by the JAX `_pack_np` served by the
    port's PolicyHTTPServer, its reply decoded by the JAX `_unpack_np`,
    the action within 1e-4 of the JAX ThreeDLotusActioner's; run_client
    over ReplayEnv; a server error raised at the client.
  * summarize_val_results / summarize_tst_results: the port's functions
    and printed tables equal to the JAX ones on the same results.
  * The Actioner's JAX keywords: 'ens1' and num_ensembles > 1 raise,
    save_obs_outs_dir writes {taskvar}-{episode}-{step}.npy.
"""
import json
import os
import queue
import threading
import urllib.request

import numpy as np
import pytest
import yaml
import flax.serialization as flax_ser

from robot3dlotus_tpu.eval import server as jserver
from robot3dlotus_tpu.eval import serving as jserving
from robot3dlotus_tpu.preprocess import evaluate_microsteps as jmicro
from robot3dlotus_tpu.scripts import summarize_tst_results as jtst
from robot3dlotus_tpu.scripts import summarize_val_results as jval
from robot3dlotus_tpu.train.datasets import store as jstore
from robot3dlotus_tpu_torch.eval import (eval_robot_pipeline_server,
                                         eval_simple_policy_server, server,
                                         serving)
from robot3dlotus_tpu_torch.eval.actioner import Actioner
from robot3dlotus_tpu_torch.eval.synthetic_obs import TASKVAR
from robot3dlotus_tpu_torch.preprocess import evaluate_microsteps as micro
from robot3dlotus_tpu_torch.scripts import summarize_tst_results as tst
from robot3dlotus_tpu_torch.scripts import summarize_val_results as val
from robot3dlotus_tpu_torch.train import checkpoint as ckpt
from robot3dlotus_tpu_torch.train.datasets import store
from robot3dlotus_tpu_torch.eval.robot_pipeline import MotionPlannerEngine
import test_torch_port_motion_planner as tmp_mp
import test_torch_port_train_step as tmp_ts
from test_torch_port_validation import POLICY, _policy_variables
from torch_port_time_limit import time_limit  # noqa: F401

TIME_LIMIT_S = 150
ATOL = 1e-4
TASKVARS = ["synthetic_task0+0", "synthetic_task1+0"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(expr_dir, store root, JAX ThreeDLotusActioner)."""
    root = tmp_path_factory.mktemp("eval")
    src = store.SyntheticStore(num_taskvars=2, episodes_per_taskvar=2,
                               steps_per_episode=3, points_per_step=120,
                               seed=7, action_mode="reach")
    data = str(root / "voxel1cm")
    w = store.LmdbWriterStore(data)
    for tv in src.taskvars():
        for ep in src.episodes(tv):
            w.put(tv, ep, src.get(tv, ep))
    w.close()
    expr = root / "expr"
    os.makedirs(expr / "logs")
    os.makedirs(expr / "ckpts")
    model = dict(POLICY, ptv3_config=dict(tmp_ts.PTV3, stage_caps=[128] * 2))
    with open(expr / "logs" / "training_config.yaml", "w") as f:
        yaml.safe_dump({"TRAIN_DATASET": {
            "data_dir": data, "num_points": 128, "rm_robot":
            "box_keep_gripper", "rm_table": True, "xyz_shift": "center",
            "use_height": True, "instr_embed_file": None,
            "taskvar_instr_file": None}, "MODEL": model}, f)
    _, variables = _policy_variables()
    with open(expr / "ckpts" / "model_step_1.msgpack", "wb") as f:
        f.write(flax_ser.to_bytes(variables))
    jax_actioner = jserving.ThreeDLotusActioner(str(expr), ckpt_step=1)
    return str(expr), data, jax_actioner


def _port_actioner(expr):
    return Actioner(os.path.join(expr, "logs", "training_config.yaml"),
                    checkpoint=os.path.join(expr, "ckpts",
                                            "model_step_1.msgpack"),
                    device="cpu")


class _Recorder:
    """An actioner's predict, recording each step's action."""

    def __init__(self, actioner):
        self.actioner, self.actions = actioner, {}

    def predict(self, **payload):
        out = self.actioner.predict(**payload)
        key = (payload["task_str"], payload["variation"],
               payload["episode_id"], payload["step_id"])
        self.actions[key] = np.asarray(out["action"], np.float32).copy()
        return out


def _in_process(mod, actioner, env, result_file):
    """mod's producer_fn and consumer_fn (a thread) over queue.Queue."""
    bq, rq = queue.Queue(), [queue.Queue()]
    t = threading.Thread(target=mod.consumer_fn,
                         args=(lambda: actioner, bq, rq),
                         kwargs=dict(max_batch=1))
    t.start()
    mod.producer_fn(0, TASKVARS, lambda: env, bq, rq[0], result_file,
                    num_demos=2, max_steps=25, seed=100,
                    checkpoint="model_step_1")
    bq.put("STOP")
    t.join(timeout=60)
    with open(result_file) as f:
        return [json.loads(line) for line in f]


def test_queue_servers_equal_jax(setup, tmp_path):
    expr, data, jax_lotus = setup
    jrec = _Recorder(jax_lotus.actioner)
    want = _in_process(jserver, jrec, jserver.ReplayEnv(
        jstore.LmdbStore(data)), str(tmp_path / "jax.jsonl"))
    prec = _Recorder(_port_actioner(expr))
    got = _in_process(server, prec, server.ReplayEnv(store.open_store(data)),
                      str(tmp_path / "port.jsonl"))
    assert got == want and len(got) == 2
    assert sorted(prec.actions) == sorted(jrec.actions)
    assert len(prec.actions) == 2 * 2 * 2   # 3 keysteps: 2 actions
    for k, a in jrec.actions.items():
        np.testing.assert_allclose(prec.actions[k], a, atol=ATOL, rtol=0,
                                   err_msg=str(k))


def test_microstep_replay_through_both_servers(setup, tmp_path):
    _, data, _ = setup
    want = _in_process(jserver, jmicro.MicrostepReplayActioner(
        store=jstore.LmdbStore(data)), jserver.ReplayEnv(
        jstore.LmdbStore(data)), str(tmp_path / "jax.jsonl"))
    got = _in_process(server, micro.MicrostepReplayActioner(
        store=store.open_store(data)), server.ReplayEnv(
        store.open_store(data)), str(tmp_path / "port.jsonl"))
    assert got == want and [r["sr"] for r in got] == [1.0, 1.0]
    args = micro.build_parser(["--microstep_data_dir", data, "--result_file",
                               str(tmp_path / "srs.jsonl")])
    assert micro.evaluate_microsteps(args) == dict.fromkeys(TASKVARS, 1.0)
    with open(tmp_path / "srs.jsonl") as f:
        assert [json.loads(x) for x in f] == [
            {"taskvar": tv, "sr": 1.0} for tv in TASKVARS]


class _Fake:
    def __init__(self, fail_batch=False, fail_items=(), fail_all=False):
        self.batch_sizes, self.fail_batch = [], fail_batch
        self.fail_items, self.fail_all = set(fail_items), fail_all

    def _act(self, p):
        if self.fail_all or p["episode_id"] in self.fail_items:
            raise ValueError(f"poisoned {p['episode_id']}")
        return {"action": np.full(8, float(p["episode_id"]), np.float32)}

    def predict(self, **p):
        self.batch_sizes.append(1)
        return self._act(p)

    def predict_batch(self, payloads):
        self.batch_sizes.append(len(payloads))
        if self.fail_batch:
            raise RuntimeError("batch path down")
        return [self._act(p) for p in payloads]


def _consume(mod, act, items, queues, **kw):
    bq, rq = queue.Queue(), [queue.Queue() for _ in range(queues)]
    for it in items:
        bq.put(it)
    bq.put("STOP")
    try:
        mod.consumer_fn(lambda: act, bq, rq, **kw)
        raised = None
    except ValueError as e:
        raised = str(e)
    out = []
    for q in rq:
        while not q.empty():
            r = q.get_nowait()
            out.append((float(r["action"][0]), "error" in r))
    return act.batch_sizes, sorted(out), raised


@pytest.mark.parametrize("case", ["drain", "poisoned", "three_strikes",
                                  "stateful", "max_batch_1", "eight_errors"])
def test_consumer_behaves_as_jax(case):
    items = [(k % 2, {"episode_id": 10 + k}) for k in range(10)]
    make, kw = {
        "drain": (lambda: _Fake(), {}),
        "poisoned": (lambda: _Fake(fail_items={11}), {}),
        "three_strikes": (lambda: _Fake(fail_batch=True), {"max_batch": 2}),
        "stateful": (lambda: _Fake(), {"stateful": True}),
        "max_batch_1": (lambda: _Fake(), {"max_batch": 1}),
        "eight_errors": (lambda: _Fake(fail_all=True), {"max_batch": 1}),
    }[case]
    got = _consume(server, make(), items, 2, **kw)
    want = _consume(jserver, make(), items, 2, **kw)
    assert got == want
    if case == "three_strikes":
        assert [b for b in got[0] if b > 1] == [2, 2, 2]
    if case == "eight_errors":
        assert got[2] == "poisoned 17"


def test_spawned_eval_server_layout_and_skipping(setup, tmp_path, capsys):
    expr, data, _ = setup
    tv_file = str(tmp_path / "taskvars.json")
    with open(tv_file, "w") as f:
        json.dump(TASKVARS, f)
    result_file = os.path.join(expr, "preds", "seed100", "results.jsonl")
    os.makedirs(os.path.dirname(result_file), exist_ok=True)
    done = {"checkpoint": "model_step_1", "task": "synthetic_task0",
            "variation": 0, "num_demos": 2, "sr": 0.5}
    with open(result_file, "w") as f:
        f.write(json.dumps(done) + "\n")
    argv = ["--expr_dir", expr, "--ckpt_step", "1", "--taskvar_file",
            tv_file, "--env", "replay", "--replay_data_dir", data,
            "--num_workers", "2", "--num_demos", "2", "--device", "cpu"]
    assert eval_simple_policy_server.main(argv) == result_file
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("eval server: ")][-1]
    stats = json.loads(line[len("eval server: "):])
    assert stats["requests"] == 2 * 2 and stats["requests_per_s"] > 0
    assert stats["producers_importing_torch"] == 0 and stats["errors"] == 0
    with open(result_file) as f:
        rows = [json.loads(x) for x in f]
    assert rows[0] == done and len(rows) == 2
    assert rows[1]["task"] == "synthetic_task1" and \
        rows[1]["checkpoint"] == "model_step_1" and \
        set(rows[1]) == set(done)
    eval_simple_policy_server.main(argv)           # nothing left to do
    assert 'eval server: {"requests": 0}' in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="RLBench"):
        eval_simple_policy_server.main(argv[:6])


def test_spawned_pipeline_server_gt_layout(tmp_path, capsys):
    """eval_robot_pipeline_server.main: GroundtruthRobotPipeline in the
    consumer on the CPU over a motion store of one GemBench taskvar."""
    model = dict(tmp_mp.MP_MODEL, ptv3_config=dict(tmp_mp.PTV3,
                                                   stage_caps=[256, 256]),
                 action_config=dict(tmp_mp.ACT, txt_ft_size=512))
    src = store.SyntheticMotionStore(num_taskvars=1, episodes_per_taskvar=1,
                                     steps_per_episode=3,
                                     points_per_step=600, seed=2)
    data = str(tmp_path / "motion")
    w = store.LmdbWriterStore(data)
    w.put(TASKVAR, "episode0", src.get("synthetic_task0+0", "episode0"))
    w.close()
    expr = tmp_path / "mp"
    os.makedirs(expr / "logs")
    with open(expr / "logs" / "training_config.yaml", "w") as f:
        yaml.safe_dump({"TRAIN_DATASET": {"num_points": 256,
                                          "data_dir": data},
                        "MODEL": model}, f)
    engine = MotionPlannerEngine(str(expr / "logs" / "training_config.yaml"),
                                 device="cpu")
    ckpt.ModelSaver(str(expr)).save(engine.model, 3)
    cfg = os.path.join(os.path.dirname(tmp_mp.__file__), "..",
                       "robot3dlotus_tpu_torch", "configs", "rlbench",
                       "robot_pipeline_gt.yaml")
    result = eval_robot_pipeline_server.main([
        "--pipeline_config_file", cfg, "--mp_expr_dir", str(expr),
        "--mp_ckpt_step", "3", "--taskvar", TASKVAR, "--env", "replay",
        "--num_workers", "1", "--num_demos", "1", "--device", "cpu"])
    stats = json.loads([x for x in capsys.readouterr().out.splitlines()
                        if x.startswith("eval server: ")][-1][13:])
    assert stats["requests"] == 2 and stats["errors"] == 0 and \
        stats["batch_sizes"] == [1, 1]
    assert result == os.path.join(str(expr), "preds-llm_gt-og_gt_coarse",
                                  "seed100", "results.jsonl")
    with open(result) as f:
        (row,) = [json.loads(x) for x in f]
    task, var = TASKVAR.split("+")
    assert row["checkpoint"] == 3 and row["task"] == task and \
        row["variation"] == int(var) and row["num_demos"] == 1
    # the released config grounds with OWLv2 and SAM, whose weights a
    # command line cannot inject: it raises, naming them
    vlm_cfg = os.path.join(os.path.dirname(cfg), "robot_pipeline.yaml")
    with pytest.raises(RuntimeError, match="RobotPipeline.*OWLv2.*SAM"):
        eval_robot_pipeline_server.main([
            "--pipeline_config_file", vlm_cfg, "--mp_expr_dir", str(expr),
            "--mp_ckpt_step", "3", "--env", "replay", "--no_gt_llm"])


def test_http_wire_equal_jax(setup, tmp_path):
    expr, data, jax_lotus = setup
    port_lotus = serving.ThreeDLotusActioner(expr, ckpt_step=1, device="cpu")
    srv = serving.PolicyHTTPServer(port_lotus, port=0)
    srv.start_background()
    url = f"http://{srv.host}:{srv.port}"
    try:
        env = server.ReplayEnv(store.open_store(data))
        obs = env.reset("synthetic_task1", 0, 1)
        payload = {"taskvar": "synthetic_task1+0", "episode_id": 1,
                   "step_id": 0, "instruction": "do the task",
                   "obs_state_dict": obs}
        req = urllib.request.Request(
            url + "/predict", data=jstore._pack_np(payload), method="POST",
            headers={"Content-Type": "application/msgpack"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = resp.read()
        got = jstore._unpack_np(body)["action"]
        want = jax_lotus.predict(**payload)["action"]
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        assert body == store._pack_np(
            port_lotus.predict(**payload))         # the reply's bytes

        client = serving.PolicyHTTPClient(url)
        rec = serving.run_client("synthetic_task0+0", client, env,
                                 num_episodes=2,
                                 output_file=str(tmp_path / "c.jsonl"))
        assert rec == {"task": "synthetic_task0", "variation": 0,
                       "num_demos": 2, "sr": rec["sr"]}
        with open(tmp_path / "c.jsonl") as f:
            assert [json.loads(x) for x in f] == [rec]
        with pytest.raises(RuntimeError, match="server error 500"):
            client.predict(taskvar="nope", step_id=0, obs_state_dict={})
    finally:
        srv.shutdown()


def _results(path):
    rows = []
    for ck, sr0 in (("model_step_100", 0.25), ("model_step_200", 0.75)):
        for i, tv in enumerate(["close_jar+0", "close_jar+1",
                                "push_button+0"]):
            rows.append({"checkpoint": ck, "task": tv.split("+")[0],
                         "variation": int(tv.split("+")[1]),
                         "num_demos": 20, "sr": sr0 + 0.05 * i})
    rows.append(dict(rows[0], sr=0.0))   # a resumed run's duplicate
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def test_summaries_equal_jax(tmp_path, capsys, monkeypatch):
    res = str(tmp_path / "preds" / "seed100" / "results.jsonl")
    _results(res)
    for aggr in (False, True):
        assert val.summarize(val.load_results(res), aggr) == \
            jval.summarize(jval.load_results(res), aggr)
    for step in (None, 200):
        assert val.load_results(res, step) == jval.load_results(res, step)
    assert val.main(["--result_file", res]) == \
        jval.main(["--result_file", res])
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:] and "model_step_200" in out

    for seed in (200, 300):
        _results(str(tmp_path / "preds" / f"seed{seed}" / "results.jsonl"))
    os.makedirs(tmp_path / "assets")
    with open(tmp_path / "assets" / "taskvars_train.json", "w") as f:
        json.dump(["close_jar+0", "push_button+0"], f)
    monkeypatch.setenv("GEMBENCH_ASSETS_ROOT", str(tmp_path))
    argv = ["--result_dir", str(tmp_path / "preds"), "--ckpt_step", "200",
            "--seeds", "200", "300", "--splits", "taskvars_train"]
    got = tst.load_seed_results(str(tmp_path / "preds"), [200, 300], 200)
    assert got == jtst.load_seed_results(str(tmp_path / "preds"),
                                         [200, 300], 200)
    assert tst.summarize_split(got, ["close_jar+0"]) == \
        jtst.summarize_split(got, ["close_jar+0"])
    capsys.readouterr()
    assert tst.main(argv) == jtst.main(argv)
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:] and "over seeds" in out


def test_actioner_jax_keywords(setup, tmp_path):
    expr, data, _ = setup
    cfg = os.path.join(expr, "logs", "training_config.yaml")
    obs = server.ReplayEnv(store.open_store(data)).reset("synthetic_task0",
                                                         0, 0)
    # the 'ens1' vote and shuffled ensembles (held against the JAX
    # Actioner in test_torch_port_variants.py) serve the same request
    for kw in ({"best_disc_pos": "ens1"}, {"num_ensembles": 2}):
        a = Actioner(cfg, device="cpu", device_preprocess=True, **kw)
        assert a.act_cfg["best_disc_pos"] == kw.get("best_disc_pos", "max")
        assert a.num_ensembles == kw.get("num_ensembles", 1)
        assert a.device_preprocess == (a.num_ensembles == 1)
        act = a.predict("synthetic_task0", 0, 2, obs, episode_id=1)["action"]
        assert act.shape == (8,) and np.isfinite(act).all()
    out_dir = str(tmp_path / "obs_outs")
    a = Actioner(cfg, device="cpu", best_disc_pos="max", num_ensembles=1,
                 save_obs_outs_dir=out_dir)
    act = a.predict("synthetic_task0", 0, 2, obs, episode_id=1)["action"]
    saved = np.load(os.path.join(out_dir, "synthetic_task0+0-1-2.npy"),
                    allow_pickle=True).item()
    np.testing.assert_array_equal(saved["action"], act)
    np.testing.assert_array_equal(saved["obs"]["pc"][0], obs["pc"][0])
