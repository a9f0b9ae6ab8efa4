"""The ground-truth task planner of 3D-LOTUS++ (the port's copy of the
oracle parts of robot3dlotus_tpu/vlm/llm_planner.py): the canonical plan of
a taskvar read from the in-context example file, its height-range split,
and the keyword heuristic for height ranges. The LLM planner and its
backends are not ported.
"""
from __future__ import annotations

import numpy as np


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
