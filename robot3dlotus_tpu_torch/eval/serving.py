"""Challenge-style HTTP serving (the port's copy of
robot3dlotus_tpu/eval/serving.py).

The JAX package's wire contract: POST /predict with a msgpack body
{taskvar, episode_id, step_id, instruction, obs_state_dict}, numpy arrays
in msgpack_numpy's format (train/datasets/store.py `_pack_np`, byte-equal
to the JAX one); the response is a msgpack {action}, or {error} with
status 500. The server is the standard library's ThreadingHTTPServer,
which runs each request in a thread, so calls into the one actioner are
serialised by a lock. The client posts with urllib.request.

    python -m robot3dlotus_tpu_torch.eval.serving --actioner 3dlotus \\
        --expr_dir <dir> --ckpt_step N [--device cpu] [--port 13000]
    python -m robot3dlotus_tpu_torch.eval.serving client \\
        --taskvar <task+var> --replay_store <store> [--server_addr URL]
"""
from __future__ import annotations

import http.server
import os
import random
import threading
import urllib.error
import urllib.request
from typing import Dict

import numpy as np

from ..train.datasets.store import _pack_np, _unpack_np
from .common import write_to_file


class RandomActioner:
    """No-model stand-in exercising the wire format."""

    def predict(self, taskvar=None, episode_id=None, step_id=None,
                instruction=None, obs_state_dict=None, **kw):
        action = np.random.randn(8).astype(np.float32)
        action[3:7] /= np.linalg.norm(action[3:7])
        action[7] = float(action[7] > 0)
        return {"action": action}


def model_checkpoint(expr_dir, ckpt_step):
    """<expr_dir>/ckpts/model_step_<N>.msgpack, else the .pt beside it,
    else None."""
    for ext in (".msgpack", ".pt"):
        path = os.path.join(expr_dir, "ckpts", f"model_step_{ckpt_step}{ext}")
        if os.path.exists(path):
            return path
    return None


class ThreeDLotusActioner:
    """Challenge wrapper around the 3D-LOTUS policy Actioner of a training
    run: its logs/training_config.yaml and model file (actioner_kw, e.g.
    device, go to the Actioner)."""

    def __init__(self, expr_dir, ckpt_step=150000, **actioner_kw):
        from .actioner import Actioner
        checkpoint = model_checkpoint(expr_dir, ckpt_step)
        if checkpoint is None:
            raise FileNotFoundError(
                f"{expr_dir}/ckpts: no model_step_{ckpt_step}.msgpack or .pt")
        self.actioner = Actioner(
            os.path.join(expr_dir, "logs", "training_config.yaml"),
            checkpoint=checkpoint, **actioner_kw)

    def predict(self, taskvar=None, episode_id=None, step_id=None,
                instruction=None, obs_state_dict=None, **kw):
        task_str, variation = taskvar.split("+")
        out = self.actioner.predict(
            task_str, int(variation), step_id, obs_state_dict, episode_id,
            instructions=[instruction] if instruction else None)
        return {"action": np.asarray(out["action"], np.float32)}


def uses_groundtruth_grounding(pipeline_config):
    """True when the config grounds objects with the simulator's masks
    (GroundtruthRobotPipeline), as the JAX eval server decides."""
    return bool(pipeline_config.get("object_grounding", {}).get(
        "use_groundtruth", False))


def require_backends(pipeline_config, vlm_pipeline=None, llm_planner=None,
                     det=None, sam=None, llm_backend=None):
    """Raises where the config's RobotPipeline would need model weights
    that are not in the repository and no backend was injected: VLM
    grounding needs an OWLv2 detector and a SAM segmenter (or a whole
    vlm_pipeline); the LLM planner needs a chat backend or a plan
    cache_file (or a whole llm_planner). The ground-truth grounding needs
    none."""
    if uses_groundtruth_grounding(pipeline_config):
        return
    missing = []
    if vlm_pipeline is None:
        if det is None:
            missing.append("OWLv2 (the detector, det=...)")
        if sam is None:
            missing.append("SAM (the segmenter, sam=...)")
    llm = pipeline_config.get("llm_planner", {})
    if llm_planner is None and not llm.get("use_groundtruth", False) and \
            llm_backend is None and not llm.get("cache_file"):
        missing.append("the LLM planner's chat model (llm_backend=..., or "
                       "llm_planner.cache_file)")
    if missing:
        raise RuntimeError(
            "RobotPipeline with VLM grounding needs weights that are not in "
            "the repository, and the port loads no Hugging Face model: "
            f"inject {', '.join(missing)} through build_pipeline, or use "
            "object_grounding.use_groundtruth "
            "(configs/rlbench/robot_pipeline_gt.yaml)")


def build_pipeline(pipeline_config, device="cuda", **backends):
    """The 3D-LOTUS++ pipeline of a pipeline config, as the JAX eval
    server builds it: GroundtruthRobotPipeline under ground-truth
    grounding, else RobotPipeline with the injected `backends`
    (vlm_pipeline, llm_planner, det, sam, llm_backend, motion_planner,
    text_embedder; require_backends says which it needs)."""
    from .robot_pipeline import GroundtruthRobotPipeline, RobotPipeline
    if uses_groundtruth_grounding(pipeline_config):
        kw = {k: backends[k] for k in ("motion_planner", "text_embedder")
              if k in backends}
        return GroundtruthRobotPipeline(pipeline_config, device=device, **kw)
    require_backends(pipeline_config, **{
        k: backends.get(k) for k in ("vlm_pipeline", "llm_planner", "det",
                                     "sam", "llm_backend")})
    return RobotPipeline(pipeline_config, device=device, **backends)


class ThreeDLotusPlusActioner:
    """Challenge wrapper around the stateful 3D-LOTUS++ pipeline: the
    per-episode cache lives in the actioner and resets at step 0."""

    def __init__(self, pipeline_config, device="cuda", **backends):
        self.pipeline = build_pipeline(pipeline_config, device=device,
                                       **backends)
        self.cache = None

    def predict(self, taskvar=None, episode_id=None, step_id=None,
                instruction=None, obs_state_dict=None, **kw):
        task_str, variation = taskvar.split("+")
        if step_id == 0:
            self.cache = None
        out = self.pipeline.predict(
            task_str=task_str, variation=int(variation),
            episode_id=episode_id, step_id=step_id,
            instructions=[instruction] if instruction else None,
            obs_state_dict=obs_state_dict, cache=self.cache)
        self.cache = out["cache"]
        return {"action": np.asarray(out["action"], np.float32)}


class PolicyHTTPServer:
    """Serves any actioner with .predict(**payload) over POST /predict,
    one call at a time."""

    def __init__(self, actioner, host="127.0.0.1", port=13000):
        self.actioner = actioner
        self.lock = threading.Lock()
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _reply(self, code, body):
                self.send_response(code)
                self.send_header("Content-Type", "application/msgpack")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path != "/predict":
                    self.send_response(404)
                    self.end_headers()
                    return
                length = int(self.headers.get("Content-Length", 0))
                payload = _unpack_np(self.rfile.read(length))
                try:
                    with outer.lock:
                        out = outer.actioner.predict(**payload)
                except Exception as e:  # 500 with the error, keep serving
                    self._reply(500, _pack_np({"error": repr(e)}))
                    return
                self._reply(200, _pack_np(out))

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.host, self.port = host, self.httpd.server_address[1]

    def serve_forever(self):
        self.httpd.serve_forever()

    def start_background(self):
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class HTTPActioner:
    """Adapts the simulator's actioner API (predict with task_str /
    variation / instructions) to the wire format over an HTTP client: one
    instruction drawn per episode (re-drawn at step 0), instructions[0]
    without an episode_id."""

    def __init__(self, client):
        self.client = client
        self._episode_instr = {}  # (taskvar, episode_id) -> instruction

    def predict(self, task_str=None, variation=None, step_id=None,
                obs_state_dict=None, episode_id=None, instructions=None):
        taskvar = f"{task_str}+{variation}"
        if episode_id is None:
            instr = instructions[0] if instructions else None
        else:
            key = (taskvar, episode_id)
            if step_id == 0:
                self._episode_instr.pop(key, None)
            if key not in self._episode_instr:
                if len(self._episode_instr) >= 32:
                    self._episode_instr.pop(next(iter(self._episode_instr)))
                self._episode_instr[key] = (
                    random.choice(instructions) if instructions else None)
            instr = self._episode_instr[key]
        out = self.client.predict(
            taskvar=taskvar, episode_id=episode_id, step_id=step_id,
            instruction=instr, obs_state_dict=obs_state_dict)
        if "error" in out:
            raise RuntimeError(f"server error: {out['error']}")
        return {"action": np.asarray(out["action"])}


class PolicyHTTPClient:
    """POSTs msgpack payloads to a PolicyHTTPServer. A reply other than
    200 raises RuntimeError with the server's error."""

    def __init__(self, url="http://127.0.0.1:13000", timeout=600):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def predict(self, **payload) -> Dict:
        req = urllib.request.Request(
            self.url + "/predict", data=_pack_np(payload), method="POST",
            headers={"Content-Type": "application/msgpack"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return _unpack_np(resp.read())
        except urllib.error.HTTPError as e:
            body = e.read()
            try:
                detail = _unpack_np(body).get("error")
            except Exception:
                detail = body[:200]
            raise RuntimeError(f"server error {e.code}: {detail}") from None


def run_client(taskvar, client, env, num_episodes=25, max_steps=25,
               output_file=None, seed=100):
    """Closed-loop challenge client: rolls `num_episodes` episodes of one
    taskvar against a policy server, posting each observation and
    executing the returned action; appends one jsonl record with the
    success rate. `env` has the ReplayEnv API (reset / step /
    instructions / close)."""
    task_str, variation = taskvar.split("+")
    success = 0
    for episode_id in range(num_episodes):
        try:
            obs = env.reset(task_str, int(variation), episode_id, seed=seed)
        except Exception:
            continue
        instruction = random.choice(env.instructions(taskvar))
        reward = 0.0
        for step_id in range(max_steps):
            out = client.predict(
                taskvar=taskvar, episode_id=episode_id, step_id=step_id,
                instruction=instruction, obs_state_dict=obs)
            if "error" in out:
                raise RuntimeError(f"server error: {out['error']}")
            try:
                obs, reward, done = env.step(np.asarray(out["action"]))
            except Exception:  # an invalid action fails the episode
                reward, done = 0.0, True
            if done or reward == 1:
                break
        success += int(reward == 1)
    rec = {"task": task_str, "variation": int(variation),
           "num_demos": num_episodes, "sr": success / max(num_episodes, 1)}
    if output_file:
        write_to_file(output_file, rec)
    return rec


def client_main(argv=None):
    """The challenge client against a running policy server, on the
    sim-free ReplayEnv (--replay_store); RLBench cannot be installed."""
    import argparse

    p = argparse.ArgumentParser(description=run_client.__doc__)
    p.add_argument("--taskvar", required=True, help="e.g. push_button+0")
    p.add_argument("--server_addr", default="http://127.0.0.1:13000")
    p.add_argument("--num_episodes", type=int, default=25)
    p.add_argument("--max_steps", type=int, default=25)
    p.add_argument("--microstep_data_dir", default="")
    p.add_argument("--replay_store", default=None,
                   help="episode store (LMDB or msgpack directory) that "
                        "ReplayEnv replays")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--output_file", default=None)
    args = p.parse_args(argv)
    if not args.replay_store:
        p.error("--replay_store is required: RLBench (the live simulator) "
                "is not available to the PyTorch port")

    from ..train.datasets.store import open_store
    from .server import ReplayEnv
    env = ReplayEnv(open_store(args.replay_store))
    rec = run_client(args.taskvar, PolicyHTTPClient(args.server_addr), env,
                     num_episodes=args.num_episodes,
                     max_steps=args.max_steps, output_file=args.output_file)
    env.close()
    print(rec, flush=True)
    return rec


def main(argv=None):
    """Serve one of the three actioner families."""
    import argparse
    import yaml

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--actioner", default="random",
                   choices=["random", "3dlotus", "3dlotus++"])
    p.add_argument("--expr_dir", help="3dlotus: experiment directory")
    p.add_argument("--ckpt_step", type=int, default=150000)
    p.add_argument("--pipeline_config", help="3dlotus++: pipeline yaml")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=13000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.actioner == "3dlotus":
        if not args.expr_dir:
            p.error("--expr_dir is required for --actioner 3dlotus")
        actioner = ThreeDLotusActioner(args.expr_dir,
                                       ckpt_step=args.ckpt_step,
                                       device=args.device)
    elif args.actioner == "3dlotus++":
        if not args.pipeline_config:
            p.error("--pipeline_config is required for --actioner 3dlotus++")
        from ..utils.assets import resolve_asset
        with open(resolve_asset(args.pipeline_config)) as f:
            actioner = ThreeDLotusPlusActioner(yaml.safe_load(f),
                                               device=args.device)
    else:
        actioner = RandomActioner()

    server = PolicyHTTPServer(actioner, host=args.host, port=args.port)
    print(f"serving {args.actioner} on http://{server.host}:{server.port}"
          "/predict", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    import sys as _sys
    # `python -m robot3dlotus_tpu_torch.eval.serving client ...` runs the
    # closed-loop challenge client; anything else serves.
    if len(_sys.argv) > 1 and _sys.argv[1] == "client":
        client_main(_sys.argv[2:])
    else:
        main()
