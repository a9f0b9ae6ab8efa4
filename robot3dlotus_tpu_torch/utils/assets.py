"""Asset-path resolution (the port's copy of robot3dlotus_tpu/utils/
assets.py): configs name repo-relative files (assets/taskvars_train.json,
...). An existing absolute path is returned as is; else the first that
exists of $GEMBENCH_ASSETS_ROOT/<path>, <path> from the working directory
and <repo root>/<path>; else the path unchanged (callers raise with
context)."""
from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def resolve_asset(path):
    if not path:
        return path
    path = str(path)
    if os.path.isabs(path):
        return path
    env_root = os.environ.get("GEMBENCH_ASSETS_ROOT")
    if env_root:
        cand = os.path.join(env_root, path)
        if os.path.exists(cand):
            return cand
    if os.path.exists(path):
        return path
    cand = os.path.join(_REPO_ROOT, path)
    return cand if os.path.exists(cand) else path
