"""Producer/consumer closed-loop evaluation server (the port's copy of
robot3dlotus_tpu/eval/server.py).

N producer processes each own a simulator and roll episodes; ONE consumer
process owns the card and answers their policy queries through queues,
draining the queries that are pending into one `predict_batch` where the
actioner has it (dynamic batching). Taskvars already in results.jsonl are
skipped; each finished taskvar's success rate is appended under a file
lock. RLBench cannot be installed here, so the producers run `ReplayEnv`
(recorded episodes of an episode store).

Only the consumer touches CUDA: this module, the env builders and the
producers import no torch (the actioner builder imports it inside the
consumer), so no producer holds a context on the card. run_eval_server
returns what it measured: per-request latency at the producers, the
batches the consumer formed and the kernel launches it made.

Sharded serving (ROBOT3DLOTUS_SERVE_MESH, eval/actioner.py): launched as a
group (torchrun / SLURM, one process a card), process 0 runs the
producers and the consumer as above and its consumer joins the group as
its process 0; every other process of the group follows (follower_fn):
it builds the same actioner and makes each call the consumer makes, as
the consumer broadcasts it before making it (the Actioner's SPMD
contract), until the consumer's stop message. A call that raises on a
follower ends it (its processes may have left the lockstep of the
forward's collectives partway, which no later call could mend): it
leaves the group and raises. A follower that dies or leaves makes the
consumer's next broadcast or collective raise, and a broadcast that
raises ends the consumer (ServingGroupLost, never answered as one failed
query), so run_eval_server raises, as for a dead producer.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import queue as queue_mod
import sys
import time
import traceback
from typing import Callable, List

import numpy as np

from .common import write_to_file


def _kernel_launches():
    """The port's kernel launch counts in this process (ops/cuda_lib.py),
    if the kernels were loaded here."""
    lib = sys.modules.get("robot3dlotus_tpu_torch.ops.cuda_lib")
    return dict(lib.LAUNCHES) if lib is not None else {}


def _serve_mesh_rank():
    """This process's rank in a launched sharded-serving group
    (ROBOT3DLOTUS_SERVE_MESH set and a launch env of several processes),
    else None."""
    if not os.environ.get("ROBOT3DLOTUS_SERVE_MESH"):
        return None
    from ..parallel import dist
    found = dist.discover_distributed_env()
    return None if found is None else found[2]


def _join_serving_group():
    """Joins the launched group (NCCL with a card, else gloo) unless this
    process is in one already; the current card is cuda:LOCAL_RANK."""
    import torch
    from ..parallel import dist
    if not dist.joined():
        dist.init_distributed("nccl" if torch.cuda.is_available()
                              else "gloo")
    if torch.cuda.is_available():
        dist.process_device("cuda")


class ServingGroupLost(RuntimeError):
    """The consumer could not send a call to the followers: the
    sharded-serving group is broken, and the consumer stops."""


def _broadcast_call(call=None):
    """The consumer's next call (method name, arguments) sent from the
    group's process 0 to the others; returns it on every process."""
    import torch.distributed as tdist
    box = [call]
    tdist.broadcast_object_list(box, src=0)
    return box[0]


def _send_call(call):
    """_broadcast_call on the consumer; its failure is ServingGroupLost."""
    try:
        _broadcast_call(call)
    except Exception as e:
        raise ServingGroupLost(f"sharded serving: the followers cannot "
                               f"be reached ({type(e).__name__}: {e})") from e


class MeshLeader:
    """The consumer's actioner in a sharded-serving group: each predict
    and predict_batch call is broadcast to the followers before it runs;
    stop() ends their loops."""

    def __init__(self, actioner):
        self.actioner = actioner
        if hasattr(actioner, "predict_batch"):
            self.predict_batch = self._predict_batch

    def _predict_batch(self, payloads):
        _send_call(("predict_batch", (payloads,), {}))
        return self.actioner.predict_batch(payloads)

    def predict(self, **payload):
        _send_call(("predict", (), payload))
        return self.actioner.predict(**payload)

    def stop(self):
        _send_call(("stop", (), {}))


def follower_fn(actioner_builder):
    """A process of a sharded-serving group other than the first: joins
    the group, builds the actioner and makes every call the consumer
    broadcasts, until its stop message; returns the number of calls
    made. A call that raises leaves the group and raises (the module
    docstring): the consumer's next collective then raises too."""
    from ..parallel import dist
    _join_serving_group()
    actioner = actioner_builder()
    calls = 0
    try:
        while True:
            name, args, kwargs = _broadcast_call()
            if name == "stop":
                return calls
            calls += 1
            getattr(actioner, name)(*args, **kwargs)
    finally:
        dist.leave()


def consumer_fn(actioner_builder, batch_queue, result_queues,
                stop_token="STOP", max_batch=None, stateful=False,
                stats_queue=None):
    """Owns the card; answers policy queries.

    Dynamic batching: after the blocking get, pending queries of other
    producers are drained (non-blocking, up to `max_batch`, default
    ROBOT3DLOTUS_EVAL_MAX_BATCH or 8) and served in ONE
    `actioner.predict_batch` where the actioner has it. `stateful`
    topologies (the pipeline's per-episode cache rides the payloads) and
    actioners without predict_batch answer one query at a time. A batch
    that raises is retried item by item; after 3 failed batches in a row
    batching is off for the run. A failed query is answered with the zero
    action and its error, unless 8 fail in a row, which raises; a lost
    sharded-serving group (ServingGroupLost) raises at once. With
    stats_queue, puts {"role": "consumer", "ready" (wall-clock time the
    actioner was built), "batch_sizes", "errors" (the queries answered
    with an error), "kernel_launches"} before returning."""
    if max_batch is None:
        max_batch = int(os.environ.get("ROBOT3DLOTUS_EVAL_MAX_BATCH", "8"))
    leader = None
    if _serve_mesh_rank() is not None:
        _join_serving_group()
        leader = MeshLeader(actioner_builder())
    actioner = leader or actioner_builder()
    ready = time.time()
    can_batch = (not stateful and max_batch > 1
                 and hasattr(actioner, "predict_batch"))
    consecutive_errors = 0
    batch_failures = 0
    batch_sizes, errors = [], 0
    saw_stop = False
    while not saw_stop:
        item = batch_queue.get()
        if item == stop_token:
            break
        items = [item]
        while can_batch and len(items) < max_batch:
            try:
                nxt = batch_queue.get_nowait()
            except queue_mod.Empty:
                break
            if nxt == stop_token:  # answer what was drained first
                saw_stop = True
                break
            items.append(nxt)
        batch_sizes.append(len(items))
        results = None
        if len(items) > 1:
            try:
                results = actioner.predict_batch([p for _, p in items])
                consecutive_errors = 0
                batch_failures = 0
            except ServingGroupLost:
                raise
            except Exception:
                traceback.print_exc()
                batch_failures += 1
                if batch_failures >= 3:
                    can_batch = False
                    print("consumer: predict_batch failed 3x in a row — "
                          "disabling dynamic batching for this run")
        if results is None:
            results = []
            for _, payload in items:
                try:  # fail the episode, not the run...
                    results.append(actioner.predict(**payload))
                    consecutive_errors = 0
                except ServingGroupLost:
                    raise
                except Exception as e:
                    consecutive_errors += 1
                    errors += 1
                    traceback.print_exc()
                    # ...unless every call fails: a model or config bug
                    if consecutive_errors >= 8:
                        raise
                    results.append({"action": np.zeros(8, np.float32),
                                    "error": str(e)})
        for (k, _), out in zip(items, results):
            result_queues[k].put(out)
    if leader is not None:
        from ..parallel import dist
        leader.stop()
        dist.leave()
    if stats_queue is not None:
        stats_queue.put({"role": "consumer", "ready": ready,
                         "batch_sizes": batch_sizes, "errors": errors,
                         "kernel_launches": _kernel_launches()})


class QueueActioner:
    """Actioner proxy in a producer process: routes predict() calls
    through the queues to the consumer, carrying the per-episode pipeline
    cache when stateful."""

    def __init__(self, proc_id, batch_queue, result_queue, stateful=False):
        self.proc_id = proc_id
        self.batch_queue = batch_queue
        self.result_queue = result_queue
        self.stateful = stateful
        self._cache = None

    def predict(self, **payload):
        if self.stateful:
            if payload.get("step_id") == 0:
                self._cache = None
            payload["cache"] = self._cache
        self.batch_queue.put((self.proc_id, payload))
        out = self.result_queue.get()
        if self.stateful:
            self._cache = out.get("cache")
        return out


def producer_fn_sim(
    proc_id, taskvars, env_builder, batch_queue, result_queue, result_file,
    num_demos=20, max_steps=25, seed=100, checkpoint=None, stateful=False,
):
    """Producer that owns a full simulator adapter exposing `evaluate()`
    (RLBenchEnv) instead of the reset/step replay API."""
    env = env_builder()
    actioner = QueueActioner(proc_id, batch_queue, result_queue, stateful)
    for taskvar in taskvars:
        task_str, variation = taskvar.split("+")
        try:
            sr = env.evaluate(
                task_str, int(variation), max_episodes=max_steps,
                num_demos=num_demos, log_dir=None, actioner=actioner,
                max_tries=10)
        except Exception as e:
            print(f"{taskvar} failed: {e}")
            continue
        write_to_file(result_file, {
            "checkpoint": checkpoint, "task": task_str,
            "variation": int(variation),
            "num_demos": num_demos, "sr": sr,
        })


def load_done_taskvars(result_file) -> set:
    done = set()
    if os.path.exists(result_file):
        with open(result_file) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                    done.add(f"{rec['task']}+{rec['variation']}")
                except (json.JSONDecodeError, KeyError):
                    continue
    return done


def producer_fn(
    proc_id, taskvars, env_builder, batch_queue, result_queue, result_file,
    num_demos=20, max_steps=25, seed=100, checkpoint=None, stateful=False,
    stats_queue=None,
):
    """Owns one simulator; rolls episodes and queries the consumer. With
    stateful=True the per-episode pipeline cache round-trips producer <->
    consumer each step, so any producer can interleave. With stats_queue,
    puts {"role": "producer", "requests" ([wall-clock time sent, ms
    waited for the answer] per query), "last" (wall-clock time of the last
    answer), "torch_imported"} at the end."""
    env = env_builder()
    requests, last = [], None
    for taskvar in taskvars:
        task_str, variation = taskvar.split("+")
        success = 0
        for demo_id in range(num_demos):
            try:
                obs = env.reset(task_str, int(variation), demo_id, seed=seed)
            except Exception as e:
                # a failed demo, never silent
                print(f"[producer {proc_id}] reset failed "
                      f"{taskvar} demo {demo_id}: {e!r}", file=sys.stderr,
                      flush=True)
                continue
            reward = 0.0
            cache = None
            for step_id in range(max_steps):
                payload = {
                    "task_str": task_str, "variation": variation,
                    "step_id": step_id, "obs_state_dict": obs,
                    "episode_id": demo_id,
                    "instructions": env.instructions(taskvar),
                }
                if stateful:
                    payload["cache"] = cache
                sent, t0 = time.time(), time.perf_counter()
                batch_queue.put((proc_id, payload))
                out = result_queue.get()
                last = time.time()
                requests.append((sent, (time.perf_counter() - t0) * 1e3))
                if stateful:
                    cache = out.get("cache")
                try:
                    obs, reward, done = env.step(out["action"])
                except Exception:
                    reward, done = 0.0, True
                if done or reward == 1:
                    break
            success += int(reward == 1)
        write_to_file(result_file, {
            "checkpoint": checkpoint, "task": task_str,
            "variation": int(variation),
            "num_demos": num_demos, "sr": success / max(num_demos, 1),
        })
    env.close()
    if stats_queue is not None:
        stats_queue.put({"role": "producer", "proc_id": proc_id,
                         "requests": requests, "last": last,
                         "torch_imported": "torch" in sys.modules})


def _drain(q, out):
    try:
        while True:
            out.append(q.get_nowait())
    except queue_mod.Empty:
        pass


def _serve(producers, consumer, stats_queue, stats):
    """Waits for the producers while the consumer lives; collects the
    stats as they come (a queue's writer cannot exit before its items are
    read)."""
    while any(p.is_alive() for p in producers):
        _drain(stats_queue, stats)
        if not consumer.is_alive():
            for p in producers:
                p.terminate()
                p.join()
            raise RuntimeError(f"eval server: the consumer exited with code "
                               f"{consumer.exitcode} while producers "
                               "waited")
        time.sleep(0.05)
    failed = [p.exitcode for p in producers if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"eval server: producers exited with codes "
                           f"{failed}")


def _summary(stats):
    """Requests/s from the consumer being ready (or the first query, if
    later) to the last answer; the latency percentiles of the queries sent
    after it was ready (those sent before also wait for its build)."""
    prods = [s for s in stats if s["role"] == "producer"]
    (cons,) = [s for s in stats if s["role"] == "consumer"]
    reqs = [r for s in prods for r in s["requests"]]
    lasts = [s["last"] for s in prods if s["last"] is not None]
    span = (max(lasts) - max(cons["ready"], min(t for t, _ in reqs))
            if reqs else 0.0)
    warm = [ms for t, ms in reqs if t >= cons["ready"]] or \
        [ms for _, ms in reqs]
    sizes = cons["batch_sizes"]
    return {"requests": len(reqs), "serving_s": span,
            "requests_per_s": len(reqs) / span if span > 0 else 0.0,
            "request_ms": [ms for _, ms in reqs],
            "requests_before_ready": sum(t < cons["ready"] for t, _ in reqs),
            "request_ms_p50": float(np.median(warm)) if warm else None,
            "request_ms_p99": float(np.percentile(warm, 99)) if warm
            else None,
            "batch_sizes": sizes,
            "mean_batch": float(np.mean(sizes)) if sizes else None,
            "errors": cons["errors"],
            "kernel_launches": cons["kernel_launches"],
            "producers_importing_torch": sum(
                bool(s["torch_imported"]) for s in prods)}


def run_eval_server(
    taskvars: List[str], actioner_builder: Callable, env_builder: Callable,
    result_file: str, num_workers=4, num_demos=20, max_steps=25, seed=100,
    checkpoint=None, stateful=False, sim_env=False, max_batch=None,
):
    """The consumer and up to num_workers producers in `spawn` processes
    (the builders must pickle: functools.partial of module-level
    functions). `checkpoint` is recorded in every result row so
    multi-checkpoint sweeps can tell runs apart; `stateful=True` is the
    pipeline-server topology. Returns None when every taskvar is already
    done, else the summary (_summary): requests, requests/s, per-request
    ms at the producers (p50, p99), the consumer's batch sizes, failed
    queries and kernel launches, and how many producers had torch
    imported. Raises if the consumer or a producer fails. In a launched
    sharded-serving group (the module docstring) every process but the
    first follows the consumer (follower_fn) and returns None."""
    rank = _serve_mesh_rank()
    if rank is not None and rank != 0:
        follower_fn(actioner_builder)
        return None
    os.makedirs(os.path.dirname(result_file) or ".", exist_ok=True)
    done = load_done_taskvars(result_file)
    todo = [tv for tv in taskvars if tv not in done]
    if not todo and rank is None:
        return None

    ctx = mp.get_context("spawn")
    batch_queue = ctx.Queue()
    stats_queue = ctx.Queue()
    result_queues = [ctx.Queue() for _ in range(num_workers)]
    consumer = ctx.Process(
        target=consumer_fn,
        args=(actioner_builder, batch_queue, result_queues, "STOP",
              max_batch, stateful, stats_queue))
    consumer.start()

    shards = [todo[i::num_workers] for i in range(num_workers)]
    producers = []
    stats = []
    try:
        for i, shard in enumerate(shards):
            if not shard:
                continue
            if sim_env:
                target, extra = producer_fn_sim, ()
            else:
                target, extra = producer_fn, (stats_queue,)
            p = ctx.Process(target=target, args=(
                i, shard, env_builder, batch_queue, result_queues[i],
                result_file, num_demos, max_steps, seed, checkpoint,
                stateful) + extra)
            p.start()
            producers.append(p)
        _serve(producers, consumer, stats_queue, stats)
        batch_queue.put("STOP")
        while consumer.is_alive():
            _drain(stats_queue, stats)
            consumer.join(timeout=0.05)
        _drain(stats_queue, stats)
        if consumer.exitcode != 0:
            raise RuntimeError(f"eval server: the consumer exited with code "
                               f"{consumer.exitcode}")
    finally:
        for p in producers + [consumer]:
            if p.is_alive():
                p.terminate()
            p.join()
    # in a sharded-serving group the consumer ran even with nothing to do:
    # the followers wait for its stop message
    return _summary(stats) if todo else None


class ReplayEnv:
    """Simulator stand-in: replays recorded episodes from a store. Every
    action advances one keystep; the episode succeeds when the action
    that reaches the last keystep lies within 5 cm of its recorded pose
    with the recorded gripper state."""

    def __init__(self, store, taskvar_instructions=None):
        self.store = store
        self.taskvar_instructions = taskvar_instructions or {}
        self._ep = None
        self._step = 0

    def instructions(self, taskvar):
        return self.taskvar_instructions.get(taskvar, ["do the task"])

    def reset(self, task_str, variation, demo_id, seed=100):
        taskvar = f"{task_str}+{variation}"
        eps = self.store.episodes(taskvar)
        self._ep = self.store.get(taskvar, eps[demo_id % len(eps)])
        self._step = 0
        return self._obs()

    def _obs(self):
        t = self._step
        ep = self._ep
        xyz = np.asarray(ep["xyz"][t], np.float32)
        rgb_f = np.asarray(ep["rgb"][t], np.float32)
        arm = ({k: np.asarray(v[t]) for k, v in ep["bbox_info"].items()},
               {k: np.asarray(v[t]) for k, v in ep["pose_info"].items()})
        obs = {
            "rgb": [rgb_f], "pc": [xyz], "gripper": ep["action"][t],
            "arm_links_info": arm,
        }
        if "sem" in ep:  # GT masks for the oracle-vision pipeline
            obs["gt_mask"] = [np.asarray(ep["sem"][t])]
        return obs

    def step(self, action):
        tgt = self._ep["action"][self._step + 1]
        pos_ok = np.linalg.norm(action[:3] - tgt[:3]) < 0.05
        open_ok = (action[-1] > 0.5) == (tgt[-1] > 0.5)
        self._step += 1
        done = self._step >= len(self._ep["xyz"]) - 1
        reward = float(pos_ok and open_ok and done)
        return (self._obs() if not done else None), reward, done

    def close(self):
        pass
