"""CLIP prompt templates (the port's copy of the prompt part of
robot3dlotus_tpu/vlm/clip_encoder.py). The CLIP encoders themselves need
weights that are not in the repository and are not ported."""
from __future__ import annotations

from typing import List

PROMPT_TEMPLATES = {
    "point cloud": "a point cloud of a {}.",
    "plain": "{}",
}

# the 3D-caption prompt ensemble: 20 prefixes x 3 suffixes = 60 prompts a
# label, averaged by the callers
_PROMPT_PREFIXES = (
    "", "A ", "A model of ", "A model of a ", "A image of ",
    "A image of a ", "A 3D model of ", "A 3D model of a ",
    "A rendering model of ", "A rendering model of a ",
    "A point cloud of ", "A point cloud of a ",
    "A point cloud model of ", "A point cloud model of a ",
    "A 3D rendering model of ", "A 3D rendering model of a ",
    "A rendering image of ", "A rendering image of a ",
    "A 3D rendering image of ", "A 3D rendering image of a ",
)
_PROMPT_SUFFIXES = (".", " with white background.", " with black context.")


def get_prompts_from_label(text: str) -> List[str]:
    return [p + text + s for p in _PROMPT_PREFIXES for s in _PROMPT_SUFFIXES]
