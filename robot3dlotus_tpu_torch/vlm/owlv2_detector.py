"""The OWLv2 class-agnostic objectness detector (the port's copy of
robot3dlotus_tpu/vlm/owlv2_detector.py).

The post-processing is numpy and exact: the size filters, the top-k and
the Gaussian soft-NMS. The OWLv2 model itself is not in the repository:
its weights are not, and the port loads no Hugging Face checkpoint. So
Owlv2ObjectDetector encodes images and texts through an injected
`backend` (an object with encode_images(images) and encode_texts(texts)
returning the fields listed there), and raises without one.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

MODEL_IDS = {
    "base": "google/owlv2-base-patch16-ensemble",
    "large": "google/owlv2-large-patch14-ensemble",
}


def soft_nms(boxes: np.ndarray, scores: np.ndarray, sigma=0.5, thresh=0.001):
    """Gaussian soft-NMS; returns the kept original indices, in the greedy
    max-score visiting order."""
    boxes = np.asarray(boxes, np.float64).copy()
    scores = np.asarray(scores, np.float64).copy()
    N = len(boxes)
    idx = np.arange(N, dtype=np.int64)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])

    for i in range(N):
        pos = i + 1
        if i != N - 1:
            maxpos = int(np.argmax(scores[pos:])) + pos
            if scores[i] < scores[maxpos]:
                boxes[[i, maxpos]] = boxes[[maxpos, i]]
                scores[[i, maxpos]] = scores[[maxpos, i]]
                areas[[i, maxpos]] = areas[[maxpos, i]]
                idx[[i, maxpos]] = idx[[maxpos, i]]
        xx1 = np.maximum(boxes[i, 0], boxes[pos:, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[pos:, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[pos:, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[pos:, 3])
        w = np.maximum(0.0, xx2 - xx1)
        h = np.maximum(0.0, yy2 - yy1)
        inter = w * h
        ovr = inter / np.maximum(areas[i] + areas[pos:] - inter, 1e-12)
        scores[pos:] *= np.exp(-(ovr * ovr) / sigma)

    return idx[scores > thresh]


def post_process_objectness(
    objectness_logits, pred_boxes_cxcywh, threshold=0.1, target_sizes=None,
    min_size_ratio=None, max_size_ratio=0.8, min_return_topk=None,
    max_return_topk=None, use_nms=False, nms_sigma=0.2, nms_thresh=0.1,
    sqrt_num_patches=60,
) -> List[Dict]:
    """(B, P) objectness logits and (B, P, 4) centre-format boxes -> per
    image {scores, boxes (corners), patch_indexs, patch_coords}: the size
    filters, the score threshold (or the top min_return_topk when nothing
    passes), the max_return_topk best, then soft-NMS."""
    objectness = 1.0 / (1.0 + np.exp(-np.asarray(objectness_logits)))
    pred_boxes = np.asarray(pred_boxes_cxcywh)
    box_sizes = np.prod(pred_boxes[..., 2:], -1)
    boxes = np.concatenate([
        pred_boxes[..., :2] - pred_boxes[..., 2:] / 2,
        pred_boxes[..., :2] + pred_boxes[..., 2:] / 2,
    ], axis=-1)

    results = []
    for s, b, bsize in zip(objectness, boxes, box_sizes):
        obj_ids = np.arange(s.shape[0])
        if min_size_ratio is not None:
            obj_ids = obj_ids[bsize[obj_ids] > min_size_ratio]
        if max_size_ratio is not None:
            obj_ids = obj_ids[bsize[obj_ids] < max_size_ratio]
        tmp = obj_ids[s[obj_ids] >= threshold]
        if len(tmp) == 0 and min_return_topk is not None:
            top = np.argsort(-s[obj_ids])[:min_return_topk]
            obj_ids = obj_ids[top]
        else:
            obj_ids = tmp
        obj_ids = obj_ids[np.argsort(-s[obj_ids], kind="stable")]
        if max_return_topk is not None:
            obj_ids = obj_ids[:max_return_topk]

        score = s[obj_ids]
        box = b[obj_ids]
        patch_index = obj_ids.astype(np.int64)
        patch_coord = np.stack(
            [patch_index % sqrt_num_patches,
             patch_index // sqrt_num_patches], -1) / sqrt_num_patches

        if target_sizes is not None:
            img_size = max(target_sizes)
            box = box * img_size
            patch_coord = patch_coord * img_size

        if use_nms:
            keep = soft_nms(box, score, sigma=nms_sigma, thresh=nms_thresh)
            score, box = score[keep], box[keep]
            patch_index, patch_coord = patch_index[keep], patch_coord[keep]

        results.append({"scores": score, "boxes": box,
                        "patch_indexs": patch_index,
                        "patch_coords": patch_coord})
    return results


class Owlv2ObjectDetector:
    """The detector of the VLM pipeline. encode_images(images) -> numpy
    {image_embeds, pred_boxes (B, P, 4) cxcywh in [0, 1],
    objectness_logits (B, P), image_class_embeds (B, P, D),
    class_logit_shift, class_logit_scale}; encode_texts(texts) ->
    {text_embeds (T, D)}: both from the injected backend."""

    def __init__(self, model_id="large", device="cpu", backend=None,
                 sqrt_num_patches=60):
        self.model_name = MODEL_IDS.get(model_id, model_id)
        self.device = device
        self.backend = backend
        self.sqrt_num_patches = getattr(backend, "sqrt_num_patches",
                                        sqrt_num_patches)

    def _need_backend(self):
        if self.backend is None:
            raise RuntimeError(
                f"OWLv2 ({self.model_name}): the detector's weights are not "
                "in the repository and the port loads no Hugging Face "
                "model; inject a backend (Owlv2ObjectDetector(backend=...)"
                " or build_pipeline(..., det=...)), or run the "
                "ground-truth grounding (robot_pipeline_gt.yaml)")
        return self.backend

    def encode_images(self, images):
        return self._need_backend().encode_images(images)

    def encode_texts(self, texts):
        return self._need_backend().encode_texts(texts)

    def post_process_objectness_detection(self, image_outputs, **kw):
        return post_process_objectness(
            image_outputs["objectness_logits"], image_outputs["pred_boxes"],
            sqrt_num_patches=self.sqrt_num_patches, **kw)
