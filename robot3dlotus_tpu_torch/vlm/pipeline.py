"""VLM object grounding (the port's copy of robot3dlotus_tpu/vlm/pipeline.py).

Per observation: OWLv2 objectness boxes -> SAM masks -> box cleaning
against the workspace, the robot and the table -> per-box point clouds
(deduplicated, 1 cm voxels) -> DBSCAN split of boxes that hold several
objects -> multi-view merging by the nearest-pair distance and the OWLv2
embedding cosine -> robot and obstacle clouds apart. All of it is host
numpy with the port's copies of the chamfer, voxel, DBSCAN and robot-box
helpers, so its objects are those of the JAX package, point for point.
The detector and the segmenter are injected (`det`, `sam`); without them
the OWLv2 and SAM shells raise, naming the weights they would need.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..ops.chamfer import min_pair_distance_np
from ..ops.voxel import voxelize_pcd_np
from ..utils.robot_box import RobotBox
from .configs import VLMRLBenchConfig, VLMRealConfig
from .owlv2_detector import Owlv2ObjectDetector
from .sam_segmentor import SAMSegmentor


@dataclass
class ObjectInfo:
    view_ids: list = field(default_factory=list)
    obj_ids: list = field(default_factory=list)
    boxes: list = field(default_factory=list)
    masks: list = field(default_factory=list)
    image_class_embeds: Optional[np.ndarray] = None  # (k, dim)
    objectness_scores: Optional[np.ndarray] = None   # (k,)
    pcd_xyz: Optional[np.ndarray] = None
    pcd_rgb: Optional[np.ndarray] = None
    captions: list = field(default_factory=list)


def weighted_average_embeds(embeds, scores, keepdim=False):
    w = np.asarray(scores, np.float64)
    w = w / max(w.sum(), 1e-9)
    out = (np.asarray(embeds, np.float64) * w[:, None]).sum(0)
    return out[None] if keepdim else out


def _normalize(v):
    return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-6)


def _dedup_points(xyz, rgb=None):
    if len(xyz) == 0:
        return xyz, rgb
    _, idx = np.unique(np.round(np.asarray(xyz, np.float64), 8), axis=0,
                       return_index=True)
    idx = np.sort(idx)
    return xyz[idx], (rgb[idx] if rgb is not None else None)


def remove_statistical_outliers_np(xyz, nb_neighbors=50, std_ratio=0.2):
    """kNN mean-distance filter (o3d remove_statistical_outlier equivalent)."""
    if len(xyz) <= nb_neighbors:
        return np.ones(len(xyz), bool)
    from ..utils.neighbors import knn_dists
    mean_d = knn_dists(xyz, nb_neighbors).mean(1)
    mu, sigma = mean_d.mean(), mean_d.std()
    return mean_d <= mu + std_ratio * sigma


class VLMPipeline:
    def __init__(self, det_model="large", sam_model="huge",
                 env_name="rlbench", det=None, sam=None):
        """det: an Owlv2ObjectDetector (or an object with its
        encode_images, encode_texts and post_process_objectness_detection);
        sam: a SAMSegmentor (or a callable like it)."""
        self.env_name = env_name
        self.vlm_config = (VLMRLBenchConfig if env_name == "rlbench"
                           else VLMRealConfig)
        self.det_model = det or Owlv2ObjectDetector(det_model)
        self.sam_model = sam or SAMSegmentor(sam_model)
        self.reset_cache()

    def reset_cache(self):
        self.cache = {}
        self.robot_box = None

    # ------------------------------------------------------------------ #
    def run(self, rgb_images, pcd_images, arm_links_info):
        self.reset_cache()
        self.robot_box = RobotBox(arm_links_info, env_name=self.env_name)
        rgb_images = np.asarray(rgb_images)
        h, w = rgb_images.shape[1:3]

        det_image_outputs = self.det_model.encode_images(rgb_images)
        self.cache["det_image_outputs"] = det_image_outputs
        det_results = self.det_model.post_process_objectness_detection(
            det_image_outputs, **self.vlm_config.det_postprocess)
        self.cache["det_results"] = det_results

        box_resize = max(w, h)
        input_boxes = [(det_results[k]["boxes"] * box_resize).tolist()
                       for k in range(len(rgb_images))]
        sam_results = self.sam_model(rgb_images, input_boxes)
        self.cache["sam_results"] = sam_results

        cleaned_det, cleaned_sam = self.clean_det_bboxes(
            det_results, sam_results, pcd_images, self.robot_box)
        self.cache["cleaned_det_results"] = cleaned_det
        self.cache["cleaned_sam_results"] = cleaned_sam

        objects = self.merge_multiview_objects(
            det_image_outputs, cleaned_det, cleaned_sam, rgb_images,
            pcd_images, self.robot_box)
        self.cache["objects"] = objects
        return self.cache

    # ------------------------------------------------------------------ #
    def _in_workspace(self, pcd_xyz):
        """Per-point workspace containment — ONE definition shared by box
        cleaning and point cleaning so the bounds semantics cannot drift."""
        cfg = self.vlm_config
        return np.all(pcd_xyz > cfg.workspace[0], -1) & \
            np.all(pcd_xyz < cfg.workspace[1], -1)

    def clean_object_pcd(self, pcd_xyz, robot_box):
        """keep points inside the workspace, above the table, outside the
        robot boxes (upstream's helper)."""
        cfg = self.vlm_config
        if len(pcd_xyz) == 0:
            return np.zeros(0, bool)
        m = self._in_workspace(pcd_xyz)
        m &= pcd_xyz[:, 2] > cfg.table_height + cfg.table_dist_threshold
        if robot_box is not None:
            m &= ~robot_box.point_mask(pcd_xyz)
        return m

    def clean_det_bboxes(self, det_results, sam_results, pcd_images,
                         robot_box):
        cfg = self.vlm_config
        new_det, new_sam = [], []
        for det_res, sam_res, pcd_img in zip(det_results, sam_results,
                                             pcd_images):
            valid = []
            if sam_res is not None:
                for k in range(len(det_res["boxes"])):
                    obj_mask = sam_res["masks"][k][0]
                    obj_pcd = np.asarray(pcd_img)[obj_mask]
                    obj_pcd, _ = _dedup_points(obj_pcd)
                    if self.env_name == "real" and len(obj_pcd):
                        keep = remove_statistical_outliers_np(
                            obj_pcd, **cfg.pcd_outlier_removal_config)
                        obj_pcd = obj_pcd[keep]
                    if len(obj_pcd) == 0:
                        continue
                    inws = self._in_workspace(obj_pcd)
                    if 1 - inws.mean() > \
                            cfg.clean_det_config["max_out_workspace_ratio"]:
                        continue
                    obj_pcd = obj_pcd[inws]
                    if len(obj_pcd) == 0:
                        continue
                    robot_ratio = robot_box.get_pc_overlap_ratio(xyz=obj_pcd)
                    if robot_ratio > cfg.clean_det_config["max_robot_ratio"]:
                        continue
                    table_ratio = float(
                        np.mean(obj_pcd[:, 2] < cfg.table_height))
                    if table_ratio > cfg.clean_det_config["max_table_ratio"]:
                        continue
                    if robot_ratio + table_ratio > 0.8:
                        continue
                    valid.append(k)
            valid = np.asarray(valid, np.int64)
            new_det.append({k: v[valid] for k, v in det_res.items()})
            new_sam.append(
                None if len(valid) == 0 else
                {k: v[valid] for k, v in sam_res.items()})
        return new_det, new_sam

    # ------------------------------------------------------------------ #
    def merge_multiview_objects(self, det_image_outputs, det_results,
                                sam_results, rgb_images, pcd_images,
                                robot_box):
        # utils/neighbors.py's DBSCAN: sklearn's labels, exactly
        from ..utils.neighbors import dbscan_labels
        import collections

        cfg = self.vlm_config
        all_objects: List[ObjectInfo] = []
        for view_id, (det_res, sam_res, rgb_img, pcd_img) in enumerate(
                zip(det_results, sam_results, rgb_images, pcd_images)):
            if sam_res is None:
                continue
            for k, (box, score) in enumerate(
                    zip(det_res["boxes"], det_res["scores"])):
                obj = ObjectInfo()
                obj.view_ids.append(view_id)
                obj.obj_ids.append(k)
                obj.boxes.append(np.asarray(box))
                obj.masks.append(sam_res["masks"][k][0])
                obj.objectness_scores = np.asarray([score])
                patch_index = det_res["patch_indexs"][k]
                obj.image_class_embeds = det_image_outputs[
                    "image_class_embeds"][view_id][patch_index][None]

                seg = sam_res["masks"][k][0]
                obj.pcd_xyz = np.asarray(pcd_img)[seg]
                keep = self.clean_object_pcd(obj.pcd_xyz, robot_box)
                obj.pcd_xyz = obj.pcd_xyz[keep]
                obj.pcd_rgb = np.asarray(rgb_img)[seg][keep]
                obj.pcd_xyz, obj.pcd_rgb = _dedup_points(
                    obj.pcd_xyz, obj.pcd_rgb)
                if len(obj.pcd_xyz) == 0:
                    continue
                vox_xyz, first = voxelize_pcd_np(obj.pcd_xyz, cfg.voxel_size)
                obj.pcd_xyz = vox_xyz.astype(np.float32)
                obj.pcd_rgb = obj.pcd_rgb[first].astype(np.uint8)
                if self.env_name == "real":
                    keep = remove_statistical_outliers_np(
                        obj.pcd_xyz, **cfg.pcd_outlier_removal_config)
                    obj.pcd_xyz = obj.pcd_xyz[keep]
                    obj.pcd_rgb = obj.pcd_rgb[keep]
                if len(obj.pcd_xyz) < max(cfg.dbscan_config["min_samples"],
                                          2):
                    continue

                labels = dbscan_labels(
                    obj.pcd_xyz,
                    eps=cfg.dbscan_config["eps"],
                    min_samples=cfg.dbscan_config["min_samples"])
                counter = collections.Counter(labels)
                num_clusters = len([l for l in counter if l != -1])
                if num_clusters > 1:
                    for label, npts in counter.items():
                        if label != -1 and npts / len(obj.pcd_xyz) > \
                                cfg.dbscan_config["min_keep_ratio"]:
                            part = copy.deepcopy(obj)
                            pm = labels == label
                            part.pcd_xyz = obj.pcd_xyz[pm]
                            part.pcd_rgb = obj.pcd_rgb[pm]
                            if len(part.pcd_xyz) > cfg.pcd_min_num_points:
                                all_objects.append(part)
                elif len(obj.pcd_xyz) > cfg.pcd_min_num_points:
                    all_objects.append(obj)

        # (sorted by point count just before merging below — nothing
        # in between is order-dependent)

        # obstacle = everything outside detected masks
        obstacle = ObjectInfo(captions=["obstacle"])
        obstacle.pcd_xyz = np.empty((0, 3), np.float32)
        obstacle.pcd_rgb = np.empty((0, 3), np.float32)
        for det_res, sam_res, rgb_img, pcd_img in zip(
                det_results, sam_results, rgb_images, pcd_images):
            om = np.ones(np.asarray(rgb_img).shape[:2], bool)
            if sam_res is not None:
                for k in range(len(det_res["boxes"])):
                    om[sam_res["masks"][k][0]] = False
            if om.sum() > 0:
                obstacle.pcd_xyz = np.concatenate(
                    [obstacle.pcd_xyz, np.asarray(pcd_img)[om]], 0)
                obstacle.pcd_rgb = np.concatenate(
                    [obstacle.pcd_rgb, np.asarray(rgb_img)[om]], 0)
        keep = self.clean_object_pcd(obstacle.pcd_xyz, robot_box=None)
        obstacle.pcd_xyz = obstacle.pcd_xyz[keep]
        obstacle.pcd_rgb = obstacle.pcd_rgb[keep]
        if len(obstacle.pcd_xyz):
            vox, first = voxelize_pcd_np(obstacle.pcd_xyz, cfg.voxel_size)
            obstacle.pcd_xyz = vox.astype(np.float32)
            obstacle.pcd_rgb = obstacle.pcd_rgb[first]

        # separate robot points
        robot = ObjectInfo(captions=["robot"])
        ridx = np.where(robot_box.point_mask(obstacle.pcd_xyz))[0] \
            if len(obstacle.pcd_xyz) else np.zeros(0, np.int64)
        if len(ridx) > 0:
            robot.pcd_xyz = obstacle.pcd_xyz[ridx]
            robot.pcd_rgb = obstacle.pcd_rgb[ridx]
            om = np.ones(len(obstacle.pcd_xyz), bool)
            om[ridx] = False
            obstacle.pcd_xyz = obstacle.pcd_xyz[om]
            obstacle.pcd_rgb = obstacle.pcd_rgb[om]

        merged: List[ObjectInfo] = []
        if all_objects:
            # re-attach obstacle fragments to their closest object
            if self.env_name == "rlbench" and len(obstacle.pcd_xyz) >= \
                    cfg.dbscan_config["min_samples"]:
                labels = dbscan_labels(
                    obstacle.pcd_xyz,
                    eps=cfg.dbscan_config["eps"],
                    min_samples=cfg.dbscan_config["min_samples"])
                counter = collections.Counter(labels)
                om = np.ones(len(obstacle.pcd_xyz), bool)
                for label, npts in counter.items():
                    if label == -1:
                        continue
                    pm = labels == label
                    if pm.mean() < 0.1:
                        continue
                    dists = [min_pair_distance_np(obstacle.pcd_xyz[pm],
                                                  o.pcd_xyz)
                             for o in all_objects]
                    best = int(np.argmin(dists))
                    if dists[best] < \
                            cfg.merge_obj_config["max_match_pcd_dist"]:
                        all_objects[best].pcd_xyz = np.concatenate(
                            [all_objects[best].pcd_xyz,
                             obstacle.pcd_xyz[pm]], 0)
                        all_objects[best].pcd_rgb = np.concatenate(
                            [all_objects[best].pcd_rgb,
                             # obstacle rgb is float32; keep the target
                             # object's dtype instead of silently promoting
                             obstacle.pcd_rgb[pm].astype(
                                 all_objects[best].pcd_rgb.dtype)], 0)
                        om[pm] = False
                obstacle.pcd_xyz = obstacle.pcd_xyz[om]
                obstacle.pcd_rgb = obstacle.pcd_rgb[om]

            all_objects.sort(key=lambda o: -len(o.pcd_xyz))
            merged.append(all_objects[0])
            for obj in all_objects[1:]:
                best = None  # (eid, pcd_dist, embed_sim)
                for eid, ex in enumerate(merged):
                    if obj.view_ids[0] in ex.view_ids:
                        continue  # never merge boxes of the same view
                    pcd_dist = min_pair_distance_np(obj.pcd_xyz, ex.pcd_xyz)
                    f1 = _normalize(weighted_average_embeds(
                        ex.image_class_embeds, ex.objectness_scores))
                    f2 = _normalize(obj.image_class_embeds[0])
                    embed_sim = float((f1 * f2).sum())
                    floor = 0.005 if self.env_name == "rlbench" else 0.01
                    if best is None or (
                            embed_sim / max(pcd_dist, floor) >
                            best[2] / max(best[1], floor)):
                        best = (eid, pcd_dist, embed_sim)
                mc = cfg.merge_obj_config
                # as upstream: only the
                # highest-RATIO candidate is threshold-checked, so a
                # candidate passing both thresholds can lose to a
                # non-qualifying higher-ratio one — kept for parity
                if best is not None and (
                        (best[2] > mc["min_match_embed_sim"]
                         and best[1] < mc["max_match_pcd_dist"])
                        or (self.env_name == "rlbench" and best[1] < 0.01)):
                    ex = merged[best[0]]
                    ex.view_ids.extend(obj.view_ids)
                    ex.obj_ids.extend(obj.obj_ids)
                    ex.boxes.extend(obj.boxes)
                    ex.masks.extend(obj.masks)
                    ex.captions.extend(obj.captions)
                    ex.pcd_xyz = np.concatenate([ex.pcd_xyz, obj.pcd_xyz], 0)
                    ex.pcd_rgb = np.concatenate([ex.pcd_rgb, obj.pcd_rgb], 0)
                    vox, first = voxelize_pcd_np(ex.pcd_xyz, cfg.voxel_size)
                    ex.pcd_xyz = vox.astype(np.float32)
                    ex.pcd_rgb = ex.pcd_rgb[first]
                    ex.image_class_embeds = np.concatenate(
                        [ex.image_class_embeds, obj.image_class_embeds], 0)
                    ex.objectness_scores = np.concatenate(
                        [ex.objectness_scores, obj.objectness_scores], 0)
                else:
                    merged.append(obj)

        if robot.pcd_xyz is not None and \
                len(robot.pcd_xyz) > cfg.pcd_min_num_points:
            merged.append(robot)
        if len(obstacle.pcd_xyz) > cfg.pcd_min_num_points:
            merged.append(obstacle)
        return [o for o in merged
                if len(o.pcd_xyz) > cfg.pcd_min_num_points]

    # ------------------------------------------------------------------ #
    def prepare_som_images(self, rgb_images, sam_results):
        """Set-of-Mark prompting inputs: stamp a numeric marker at a point
        guaranteed inside each SAM mask (as upstream;
        font asset replaced with PIL's built-in default). Returns
        (som_images list of PIL.Image or None, num_objects list)."""
        from PIL import Image, ImageDraw, ImageFont
        som_images, num_objects = [], []
        for sam_res, rgb_img in zip(sam_results, rgb_images):
            if sam_res is None:
                som_images.append(None)
                num_objects.append(0)  # keep the lists view-aligned
                continue
            img = Image.fromarray(np.asarray(rgb_img, np.uint8)).convert(
                "RGB")
            draw = ImageDraw.ImageDraw(img)
            font = ImageFont.load_default()
            masks = sam_res["masks"]
            n_marked = 0
            for k, m in enumerate(masks):
                m = np.asarray(m)
                if m.ndim == 3:
                    m = m[0]
                xsum, ysum = m.sum(0), m.sum(1)
                if xsum.sum() == 0:
                    continue
                x = int(np.median(np.nonzero(xsum)[0]))
                y = int(np.median(np.nonzero(ysum)[0]))
                if not bool(m[y, x]):  # median center fell outside the mask
                    col = np.nonzero(m[:, x])[0]
                    row = np.nonzero(m[y, :])[0]
                    if xsum[x] > ysum[y] and len(col):
                        y = int(np.median(col))
                    elif len(row):
                        x = int(np.median(row))
                if not bool(m[y, x]):
                    # disjoint components: both medians fell in the gap
                    # between blobs (upstream's int cast of the empty-
                    # slice NaN median crashes here) — snap to the nearest
                    # actual mask pixel so the marker stays inside the mask
                    ys_, xs_ = np.nonzero(m)
                    j = int(np.argmin((ys_ - y) ** 2 + (xs_ - x) ** 2))
                    y, x = int(ys_[j]), int(xs_[j])
                draw.rectangle([x - 6, y - 6, x + 6, y + 6], fill="black")
                draw.text((x - 4, y - 6), str(k + 1), fill="white", font=font)
                n_marked += 1
            som_images.append(img)
            # markers actually drawn (empty masks are skipped above), so a
            # captioning prompt's claimed marker count matches the image
            num_objects.append(n_marked)
        return som_images, num_objects

    def generate_3d_captions(self, objects, caption_3d_model=None):
        """Hook for a pluggable 3D captioner over grounded object clouds
        (upstream's hook): obstacle/robot groups are
        skipped; each remaining object gains a .caption_3d."""
        model = caption_3d_model or getattr(self, "caption_3d_model", None)
        if model is None:
            return objects
        for obj in objects:
            if obj.captions and obj.captions[0] in ("obstacle", "robot"):
                continue
            obj.caption_3d = model(obj.pcd_xyz, obj.captions)
        return objects

    def ground_object_with_query(self, text, objects=None, return_sims=False):
        """Text -> best object by OWLv2 text/image embedding cosine
        (as upstream). With return_sims, the third
        element lists similarities of the embeds-bearing candidates in
        object order (upstream's it_sims — NOT aligned to `objects`
        when some lack embeds; the returned best id IS a true object
        index, unlike upstream's filtered-list argmax)."""
        objects = objects if objects is not None else self.cache["objects"]
        query = _normalize(
            self.det_model.encode_texts([text])["text_embeds"][0])
        sims, cand_ids = [], []
        for i, obj in enumerate(objects):
            if obj.image_class_embeds is None:
                continue
            emb = _normalize(weighted_average_embeds(
                obj.image_class_embeds, obj.objectness_scores))
            sims.append(float((query * emb).sum()))
            cand_ids.append(i)
        if not sims:
            out = (None, None)
        else:
            best = cand_ids[int(np.argmax(sims))]
            out = (best, objects[best])
        if return_sims:
            return out + (sims,)
        return out

    def classify_objects_with_queries(self, texts, objects=None,
                                      add_robot_obstacle=True):
        """One label per input object, positionally aligned: robot/obstacle
        entries carry their caption when add_robot_obstacle else None
        (dropping them mid-list would misalign labels[i] with objects[i])."""
        objects = objects if objects is not None else self.cache["objects"]
        query = _normalize(
            self.det_model.encode_texts(texts)["text_embeds"])
        labels = []
        for obj in objects:
            if obj.captions and obj.captions[0] in ("robot", "obstacle"):
                labels.append(obj.captions[0] if add_robot_obstacle
                              else None)
                continue
            emb = _normalize(weighted_average_embeds(
                obj.image_class_embeds, obj.objectness_scores))
            sims = query @ emb
            labels.append(texts[int(np.argmax(sims))])
        return labels
