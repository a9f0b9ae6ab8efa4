"""The task planners of 3D-LOTUS++ (the port's copy of
robot3dlotus_tpu/vlm/llm_planner.py).

LLMTaskPlanner turns an instruction into a short program over six action
primitives (grasp, move_grasped_object, rotate_grasped_object, push_down,
push_forward, release) by in-context prompting: the training instructions
most similar to the query (SentenceSim) bring their example plans into the
prompt, and a chat model completes the query. The chat model is injected
(`backend(messages, temperature=...) -> text`), or plans come from a plan
cache file (jsonl of {instruction, results}); the Llama checkpoint and the
hosted endpoints of the JAX package's HFChatBackend / OpenAICompatBackend
are not in the repository and are not ported. SentenceSim is the hashed
bag-of-words cosine (the JAX package's fallback when no sentence model
loads); a configured sentence model raises, since none is in the
repository. GroundtruthTaskPlanner is the oracle: the canonical plan of a
taskvar from the in-context example file, and its height-range split.
"""
from __future__ import annotations

import json
import os
import random
import re
import string
import zlib
from typing import Dict, List, Tuple

import numpy as np


class SentenceSim:
    """Sentence embeddings for the example retrieval: the hashed
    bag-of-words vector (crc32 of each word and each bigram, 512 bins,
    unit norm)."""

    def __init__(self, model_path=None):
        self.model_path = model_path or os.environ.get("SENTENCE_MODEL_PATH")
        if self.model_path:
            raise RuntimeError(
                f"sentence model {self.model_path!r}: the port has no "
                "sentence encoder to load (its weights are not in the "
                "repository); unset SENTENCE_MODEL_PATH to use the "
                "bag-of-words similarity")

    def embed(self, sentences: List[str]) -> np.ndarray:
        return np.stack([self._bow(s) for s in sentences])

    @staticmethod
    def _bow(sentence, dim=512):
        v = np.zeros(dim, np.float32)
        words = re.findall(r"[a-z]+", sentence.lower())
        for i, w in enumerate(words):
            # crc32: stable across processes, unlike Python hash()
            v[zlib.crc32(w.encode("utf-8")) % dim] += 1.0
            if i + 1 < len(words):
                bigram = (w + "_" + words[i + 1]).encode("utf-8")
                v[zlib.crc32(bigram) % dim] += 0.5
        n = np.linalg.norm(v)
        return v / n if n > 0 else v


SYSTEM_PROMPT = ("You are an expert assistant that writes short Python "
                 "programs to control a tabletop robot arm.")

PRIMITIVES_PROMPT = """Write Python code to control a robot arm on a tabletop.
Complete the code for each new query given the visible objects, following the
patterns in the provided context. No imports, no explanations outside code
comments, no loops.

Only these action primitives are available:
1. `grasp(object)`: open-gripper grasp of the named object; returns it.
2. `move_grasped_object(target)`: move the held object to a place, a
   previously returned object, or a small directional move (up/down/out/in);
   returns the held object.
3. `rotate_grasped_object()`: rotate the gripper while holding; returns the
   held object.
4. `push_down(object)`: press the object vertically (e.g. a button).
5. `push_forward(object, target)`: push the object toward a target (or a
   short forward push when no target is given).
6. `release()`: open the gripper.

Use only visible objects (new ones may appear after opening things). Plan
step by step. Context examples follow:
"""

HEIGHT_SYSTEM = "You are a highly skilled assistant for robot manipulation."
HEIGHT_USER1 = """Given a target level of an articulated object and the
object's total height, answer with two numbers: the height range of that
level. Follow the example pattern; no explanations.

target: bottom drawer handle
height: 0.4
target height range: [0.1, 0.2]

target: top drawer handle
height: 0.4
target height range: [0.3, 0.4]

target: bottom shelf
height: 0.5
target height range: [0, 0.1]

target: middle shelf
height: 0.5
target height range: [0.15, 0.25]"""
ASSISTANT_ACK = "Got it. I will complete what you give me next."


class LLMTaskPlanner:
    """query -> (the chat model's text, the plan's code lines): from the
    plan cache when it holds the query, else from the backend prompted
    with up to `topk` retrieved examples (one example per taskvar, drawn
    from a seeded random.Random)."""

    def __init__(self, prompt_dir=None, asset_dir=None, backend=None,
                 cache_file=None, temperature=0.0, topk=20, seed=0):
        self.backend = backend
        self.temperature = temperature
        self.topk = topk
        self.rng = random.Random(seed)
        self.sent_sim = SentenceSim()

        self.taskvar_examples = {}
        if prompt_dir and os.path.exists(
                os.path.join(prompt_dir, "in_context_examples.txt")):
            self.taskvar_examples = parse_in_context_examples(
                os.path.join(prompt_dir, "in_context_examples.txt"))

        self.taskvar_instructions = {}
        if asset_dir:
            tv_file = os.path.join(asset_dir, "taskvars_train.json")
            instr_file = os.path.join(asset_dir,
                                      "taskvars_instructions_new.json")
            if os.path.exists(tv_file) and os.path.exists(instr_file):
                with open(tv_file) as f:
                    trn = set(json.load(f))
                with open(instr_file) as f:
                    instrs_of = json.load(f)
                self.taskvar_instructions = {
                    tv: [i + "." for i in instrs]
                    for tv, instrs in instrs_of.items() if tv in trn}
        self.instr_to_taskvar = {
            instr: tv for tv, instrs in self.taskvar_instructions.items()
            for instr in instrs}
        self.trn_instrs = list(self.instr_to_taskvar.keys())
        self.trn_embeds = (self.sent_sim.embed(self.trn_instrs)
                           if self.trn_instrs else None)

        self.cache: Dict[str, Tuple[str, List[str]]] = {}
        if cache_file and os.path.exists(cache_file):
            with open(cache_file) as f:
                for line in f:
                    item = json.loads(line)
                    plans = [l.strip() for l in item["results"].split("\n")]
                    plans = [l for l in plans
                             if l and not l.startswith("#")]
                    self.cache[item["instruction"]] = (item["results"], plans)

    def _select_examples(self, query):
        if self.trn_embeds is None:
            return ""
        q = self.sent_sim.embed([query])[0]
        sims = self.trn_embeds @ q
        order = np.argsort(-sims)
        picked, used = [], set()
        for idx in order:
            tv = self.instr_to_taskvar[self.trn_instrs[idx]]
            if tv in used:
                continue
            used.add(tv)
            if tv in self.taskvar_examples:
                example = self.rng.choice(self.taskvar_examples[tv])
                q_line = example[0].format(instruction=self.trn_instrs[idx])
                picked.append("\n".join([q_line] + example[2:]))
            if len(picked) >= self.topk:
                break
        return "\n\n".join(picked)

    def __call__(self, query, context=None, verbose=False):
        if query in self.cache:
            return self.cache[query]
        if query[-1] not in string.punctuation:
            query = f"{query}."
        user2 = f"# query: {query}"
        if context is not None:
            user2 += f"\n# objects = {context}"
        examples = self._select_examples(query)
        messages = [
            {"role": "system", "content": SYSTEM_PROMPT},
            {"role": "user", "content": PRIMITIVES_PROMPT + examples},
            {"role": "assistant", "content": ASSISTANT_ACK},
            {"role": "user", "content": user2},
        ]
        if self.backend is None:
            raise RuntimeError(
                f"no plan for {query!r} in the plan cache and no chat "
                "backend: the LLM's weights are not in the repository; "
                "inject a backend (LLMTaskPlanner(backend=...)), give a "
                "plan cache_file, or use the ground-truth planner")
        results = self.backend(messages, temperature=self.temperature)
        plans = [l.strip() for l in results.split("\n")]
        plans = [l for l in plans if l and not l.startswith("#")]
        self.cache[query] = (results, plans)
        return results, plans

    def estimate_height_range(self, target_name, obj_height):
        if self.backend is None:
            return heuristic_height_range(target_name, obj_height)
        messages = [
            {"role": "system", "content": HEIGHT_SYSTEM},
            {"role": "user", "content": HEIGHT_USER1},
            {"role": "assistant", "content": ASSISTANT_ACK},
            {"role": "user", "content": (
                f"target: {target_name}\nheight: {obj_height}\n"
                "target height range: ")},
        ]
        results = self.backend(messages, temperature=self.temperature)
        lines = [l.strip() for l in results.split("\n")
                 if l.strip() and not l.startswith("#")]
        try:
            import ast
            return np.array(ast.literal_eval(lines[0]), np.float64)
        except Exception:
            return None




def heuristic_height_range(target_name, obj_height):
    """Split the object height by level keyword (bottom, middle, top), as
    the planner prompt's examples do; None for any other target."""
    t = target_name.lower()
    h = float(obj_height)
    if "bottom" in t:
        return np.array([0.0 if "shelf" in t else h * 0.25, h * 0.45])
    if "middle" in t:
        return np.array([h * 0.3, h * 0.6])
    if "top" in t:
        return np.array([h * 0.7, h * 1.0])
    return None


def parse_in_context_examples(path):
    """'# taskvar:'-delimited example blocks -> {taskvar: [example lines,
    ...]}, the query line kept as a '{instruction}' template."""
    with open(path) as f:
        data = [x.strip() for x in f.readlines() if x.strip()]
    taskvar_examples = {}
    taskvar = None
    for line in data:
        if line.startswith("# taskvar:"):
            taskvar = line.split("# taskvar:")[-1].strip()
            taskvar_examples.setdefault(taskvar, [])
            taskvar_examples[taskvar].append([])
        elif line.startswith("# query:"):
            taskvar_examples[taskvar][-1].append("# query: {instruction}")
        elif taskvar is not None:
            taskvar_examples[taskvar][-1].append(line)
    return taskvar_examples


class GroundtruthTaskPlanner:
    """Oracle planner: the first example plan of a taskvar."""

    def __init__(self, gt_plan_file):
        self.taskvar_examples = parse_in_context_examples(gt_plan_file)

    def __call__(self, taskvar):
        example = self.taskvar_examples[taskvar][0]
        return [line for line in example if not line.startswith("#")]

    def estimate_height_range(self, target_name, obj_height):
        """Quarters for 'middle bottom' / 'middle top', thirds otherwise."""
        h = float(obj_height)
        t = target_name
        if "middle bottom" in t:
            zrange = [h / 4 * 1, h / 4 * 2]
        elif "middle top" in t:
            zrange = [h / 4 * 2, h / 4 * 3]
        elif "bottom" in t:
            zrange = [0, h / 3]
        elif "middle" in t:
            zrange = [h / 3, h / 3 * 2]
        elif "top" in t:
            zrange = [h / 3 * 2, h]
        else:
            zrange = [0, h]
        return np.array(zrange)
