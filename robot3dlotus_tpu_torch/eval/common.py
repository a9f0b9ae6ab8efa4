"""Shared eval utilities (the port's copy of robot3dlotus_tpu/eval/common.py).

write_to_file appends one JSON line to a results file under an exclusive
lock on `<file>.lock` (fcntl.flock), so producer processes of the eval
server can append at once. parse_code parses one line of a task plan,
such as `cube = push_forward(object="red cube", target="green square")`,
into {action, object, target, is_object_variable, is_target_variable,
not_objects, ret_val}, with underscores in the action replaced by spaces
and the literal targets 'up' / 'out' / 'down' folded into the action.
"""
from __future__ import annotations

import fcntl
import json
import re
from typing import Dict, Optional


def write_to_file(filepath, data: Dict):
    with open(filepath + ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            with open(filepath, "a") as f:
                f.write(json.dumps(data) + "\n")
                f.flush()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)

_PATTERN = re.compile(
    r'^((?P<ret_val>\w+) = ){0,1}(?P<action>\w+)\('
    r'(object=(?P<object>[\w\s"\']+)){0,1}(,\s){0,1}'
    r'(target=(?P<target>[\w\s"\']+)){0,1}(,\s){0,1}'
    r'(not=\[(?P<not_objects>[\w\s"\',]+)\]){0,1}\)'
)


def _name(arg):
    """(name, is_variable): a quoted argument is a literal name, a bare one
    a variable returned by an earlier plan line."""
    if arg[0] == arg[-1] and arg[0] in ("\"", "'"):
        return arg[1:-1], False
    return arg, True


def parse_code(code: str) -> Optional[Dict]:
    res = _PATTERN.search(code)
    if res is None or res["action"] is None:
        return None
    action_name = res["action"].replace("_", " ")
    not_objects = None
    if res["not_objects"] is not None:
        not_objects = [x.strip() for x in res["not_objects"].split(",")]
    object_name, is_object_variable = None, False
    if res["object"] is not None:
        object_name, is_object_variable = _name(res["object"])
    target_name, is_target_variable = None, False
    if res["target"] is not None:
        target_name, is_target_variable = _name(res["target"])
        if target_name in ("up", "out", "down"):
            action_name = f"{action_name} {target_name}"
            target_name = None
    return dict(
        action=action_name, object=object_name, target=target_name,
        is_target_variable=is_target_variable,
        is_object_variable=is_object_variable,
        not_objects=not_objects, ret_val=res["ret_val"],
    )
