"""SAM box-prompted segmentation (the port's copy of
robot3dlotus_tpu/vlm/sam_segmentor.py): the best of SAM's three masks per
box, exact. SAM's weights are not in the repository, so SAMSegmentor
segments through an injected `backend` and raises without one.
"""
from __future__ import annotations

import numpy as np

MODEL_IDS = {
    "base": "facebook/sam-vit-base",
    "huge": "facebook/sam-vit-huge",
    "large": "facebook/sam-vit-huge",
}


def select_best_masks(scores, masks):
    """Per box, the mask whose IoU score is highest. scores: (n, 3);
    masks: (n, 3, H, W) -> (scores (n, 1), masks (n, 1, H, W))."""
    scores = np.asarray(scores)
    masks = np.asarray(masks)
    best = np.argmax(scores, axis=1)
    rows = np.arange(scores.shape[0])
    return scores[rows, best][:, None], masks[rows, best][:, None]


class SAMSegmentor:
    """__call__(images (B, H, W, 3) uint8, boxes: per image a list of
    pixel boxes) -> per image None (no boxes) or {scores (n, 1), masks (n,
    1, H, W) bool}. The backend's call(images, boxes) returns per image
    None or {scores (n, 3), masks (n, 3, H, W)}, SAM's three masks a box."""

    def __init__(self, model_id="huge", device="cpu", backend=None):
        self.model_name = MODEL_IDS.get(model_id, model_id)
        self.device = device
        self.backend = backend

    def __call__(self, images, boxes, points=None, keep_best_mask=True):
        if self.backend is None:
            raise RuntimeError(
                f"SAM ({self.model_name}): the segmenter's weights are not in "
                "the repository and the port loads no Hugging Face model; "
                "inject a backend (SAMSegmentor(backend=...) or "
                "build_pipeline(..., sam=...)), or run the ground-truth "
                "grounding (robot_pipeline_gt.yaml)")
        results = []
        for i, out in enumerate(self.backend(images, boxes)):
            if out is None or len(boxes[i]) == 0:
                results.append(None)
                continue
            scores, masks = np.asarray(out["scores"]), np.asarray(out["masks"])
            if keep_best_mask:
                scores, masks = select_best_masks(scores, masks)
            results.append({"scores": scores, "masks": masks.astype(bool)})
        return results
