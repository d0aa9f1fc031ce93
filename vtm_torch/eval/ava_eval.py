"""AVA action-detection evaluation — PASCAL-style frame mAP (copy of
``vtm/eval/ava_eval.py``; numpy only, every file opened through
``utils/pathmgr.py``).

Functional parity targets:
  slowfast/utils/ava_eval_helper.py (read_csv:48-83, read_exclusions
  :85-101, read_labelmap:103-119, evaluate_ava:131-166,
  run_evaluation:168-243, get_ava_eval_data:245-282, write_results
  :284-300)
  ava_evaluation/ (the ~2.8k-LoC vendored TF object-detection
  evaluator) — re-expressed as the ~100 lines of numpy it actually
  computes for AVA: per-class greedy IoU matching (threshold 0.5,
  highest-score detection claims each ground-truth box once) and
  VOC-style AP (monotone precision envelope integral,
  metrics.py:74-133). Held against ``vtm``'s copy in
  tests/test_torch_ava_eval.py.
"""

from __future__ import annotations

import csv as csv_lib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Set

import numpy as np

from vtm_torch.utils.logging import get_logger
from vtm_torch.utils.pathmgr import pathmgr

logger = get_logger(__name__)


def make_image_key(video_id, timestamp) -> str:
    return "%s,%04d" % (video_id, int(timestamp))


def read_csv(csv_file, class_whitelist=None, load_score=False):
    """AVA-format csv -> (boxes, labels, scores) dicts keyed by
    "video,sec"; boxes as [y1, x1, y2, x2]."""
    boxes = defaultdict(list)
    labels = defaultdict(list)
    scores = defaultdict(list)
    with pathmgr.open(csv_file, "r") as f:
        for row in csv_lib.reader(f):
            assert len(row) in (7, 8), f"Wrong number of columns: {row}"
            image_key = make_image_key(row[0], row[1])
            x1, y1, x2, y2 = (float(n) for n in row[2:6])
            action_id = int(row[6])
            if class_whitelist and action_id not in class_whitelist:
                continue
            boxes[image_key].append([y1, x1, y2, x2])
            labels[image_key].append(action_id)
            scores[image_key].append(float(row[7]) if load_score else 1.0)
    return boxes, labels, scores


def read_exclusions(exclusions_file) -> Set[str]:
    excluded = set()
    if exclusions_file:
        with pathmgr.open(exclusions_file, "r") as f:
            for row in csv_lib.reader(f):
                assert len(row) == 2, f"Expected only 2 columns, got: {row}"
                excluded.add(make_image_key(row[0], row[1]))
    return excluded


def read_labelmap(labelmap_file):
    """pbtxt label map -> (categories, class_id set)."""
    labelmap = []
    class_ids = set()
    name = ""
    with pathmgr.open(labelmap_file, "r") as f:
        for line in f:
            if line.startswith("  name:"):
                name = line.split('"')[1]
            elif line.startswith("  id:") or line.startswith("  label_id:"):
                class_id = int(line.strip().split(" ")[-1])
                labelmap.append({"id": class_id, "name": name})
                class_ids.add(class_id)
    return labelmap, class_ids


def _iou_matrix(det: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Pairwise IoU for [N,4]/[M,4] boxes in [y1,x1,y2,x2]
    (ava_evaluation/np_box_ops.py)."""
    area_d = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    area_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    y1 = np.maximum(det[:, None, 0], gt[None, :, 0])
    x1 = np.maximum(det[:, None, 1], gt[None, :, 1])
    y2 = np.minimum(det[:, None, 2], gt[None, :, 2])
    x2 = np.minimum(det[:, None, 3], gt[None, :, 3])
    inter = np.clip(y2 - y1, 0, None) * np.clip(x2 - x1, 0, None)
    union = area_d[:, None] + area_g[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def compute_average_precision(precision: np.ndarray, recall: np.ndarray) -> float:
    """VOC-style all-point AP (vendored metrics.py:74-133)."""
    if precision.size == 0:
        return 0.0
    recall = np.concatenate([[0], recall, [1]])
    precision = np.concatenate([[0], precision, [0]])
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = np.maximum(precision[i], precision[i + 1])
    idx = np.where(recall[1:] != recall[:-1])[0] + 1
    return float(np.sum((recall[idx] - recall[idx - 1]) * precision[idx]))


class PascalDetectionEvaluator:
    """Per-class greedy-matching PASCAL mAP evaluator (the AVA subset of
    ava_evaluation/object_detection_evaluation.py:100-360 +
    per_image_evaluation.py:261-360: no group-of, no masks)."""

    def __init__(self, categories, matching_iou_threshold: float = 0.5):
        self.categories = categories
        self.iou_threshold = matching_iou_threshold
        self._gt: Dict[str, dict] = {}
        self._det: Dict[str, dict] = {}

    def add_single_ground_truth_image_info(self, image_key, boxes, classes,
                                           difficult=None):
        self._gt[image_key] = {
            "boxes": np.asarray(boxes, dtype=float).reshape(-1, 4),
            "classes": np.asarray(classes, dtype=int),
            "difficult": (
                np.asarray(difficult, dtype=bool)
                if difficult is not None
                else np.zeros(len(classes), dtype=bool)
            ),
        }

    def add_single_detected_image_info(self, image_key, boxes, classes, scores):
        self._det[image_key] = {
            "boxes": np.asarray(boxes, dtype=float).reshape(-1, 4),
            "classes": np.asarray(classes, dtype=int),
            "scores": np.asarray(scores, dtype=float),
        }

    def evaluate(self, prefix: str = "PascalBoxes") -> dict:
        aps = {}
        # one pass over gt/detections up front instead of re-scanning
        # every image per category (80 classes x ~24k keys of tiny
        # numpy ops is minutes of pure-Python work per eval); per-class
        # detection keys keep INSERTION order, preserving the greedy
        # matching order below
        num_gt_per_class: dict = defaultdict(int)
        for gt_info in self._gt.values():
            valid = gt_info["classes"][~gt_info["difficult"]]
            for c, cnt in zip(*np.unique(valid, return_counts=True)):
                num_gt_per_class[int(c)] += int(cnt)
        det_keys_per_class: dict = defaultdict(list)
        for key, det in self._det.items():
            for c in np.unique(det["classes"]):
                det_keys_per_class[int(c)].append(key)
        for cat in self.categories:
            cid = cat["id"]
            scores_all: List[np.ndarray] = []
            tp_all: List[np.ndarray] = []
            num_gt = num_gt_per_class[cid]
            if num_gt == 0:
                continue
            for key in det_keys_per_class[cid]:
                det = self._det[key]
                sel = det["classes"] == cid
                # NOTE: the vendored fork's per_image_evaluation has no
                # NMS/score-sort stage (upstream TF OD API sorts inside
                # non_max_suppression) — greedy matching runs in the
                # detections' INSERTION order; replicate that.
                d_boxes = det["boxes"][sel]
                d_scores = det["scores"][sel]
                gt = self._gt.get(key)
                if gt is None:
                    g_boxes = np.zeros((0, 4))
                    g_difficult = np.zeros(0, dtype=bool)
                else:
                    g_sel = gt["classes"] == cid
                    g_boxes = gt["boxes"][g_sel]
                    g_difficult = gt["difficult"][g_sel]
                tp = np.zeros(len(d_boxes), dtype=bool)
                keep = np.ones(len(d_boxes), dtype=bool)
                if len(g_boxes):
                    iou = _iou_matrix(d_boxes, g_boxes)
                    best = np.argmax(iou, axis=1)
                    gt_taken = np.zeros(len(g_boxes), dtype=bool)
                    for i in range(len(d_boxes)):
                        g = best[i]
                        if iou[i, g] >= self.iou_threshold:
                            if g_difficult[g]:
                                keep[i] = False  # matched difficult: ignored
                            elif not gt_taken[g]:
                                tp[i] = True
                                gt_taken[g] = True
                scores_all.append(d_scores[keep])
                tp_all.append(tp[keep])
            if scores_all:
                scores = np.concatenate(scores_all)
                tps = np.concatenate(tp_all)
                order = np.argsort(-scores, kind="stable")
                tps = tps[order]
                cum_tp = np.cumsum(tps)
                cum_fp = np.cumsum(~tps)
                precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-12)
                recall = cum_tp / num_gt
                ap = compute_average_precision(precision, recall)
            else:
                ap = 0.0
            aps[
                f"{prefix}_PerformanceByCategory/AP@{self.iou_threshold}IOU/"
                f"{cat['name']}"
            ] = ap
        mean_ap = float(np.mean(list(aps.values()))) if aps else np.nan
        return {f"{prefix}_Precision/mAP@{self.iou_threshold}IOU": mean_ap, **aps}


def run_evaluation(categories, groundtruth, detections, excluded_keys,
                   verbose: bool = True) -> dict:
    """Reference ava_eval_helper.run_evaluation:168-243."""
    evaluator = PascalDetectionEvaluator(categories)
    boxes, labels, _ = groundtruth
    for image_key in boxes:
        if image_key in excluded_keys:
            logger.info("Excluded timestamp in ground truth: %s", image_key)
            continue
        evaluator.add_single_ground_truth_image_info(
            image_key, boxes[image_key], labels[image_key]
        )
    boxes, labels, scores = detections
    for image_key in boxes:
        if image_key in excluded_keys:
            logger.info("Excluded timestamp in detections: %s", image_key)
            continue
        evaluator.add_single_detected_image_info(
            image_key, boxes[image_key], labels[image_key], scores[image_key]
        )
    metrics = evaluator.evaluate()
    if verbose:
        for k, v in sorted(metrics.items()):
            logger.info("%s: %.6f", k, v)
    return metrics


def get_ava_eval_data(scores, boxes, metadata, class_whitelist,
                      video_idx_to_name=None):
    """[N, C] scores + [N, 5] (batch,x1,y1,x2,y2) boxes + [N, 2]
    (video_idx, sec) metadata -> csv-style dicts
    (reference ava_eval_helper.py:245-282)."""
    out_scores = defaultdict(list)
    out_labels = defaultdict(list)
    out_boxes = defaultdict(list)
    for i in range(scores.shape[0]):
        video_idx = int(np.round(metadata[i][0]))
        sec = int(np.round(metadata[i][1]))
        key = video_idx_to_name[video_idx] + "," + "%04d" % sec
        batch_box = list(np.asarray(boxes[i]).tolist())
        batch_box = [batch_box[j] for j in [0, 2, 1, 4, 3]]  # -> y1,x1,y2,x2
        for cls_idx, score in enumerate(np.asarray(scores[i]).tolist()):
            if cls_idx + 1 in class_whitelist:
                out_scores[key].append(score)
                out_labels[key].append(cls_idx + 1)
                out_boxes[key].append(batch_box[1:])
    return out_boxes, out_labels, out_scores


def write_results(detections, filename: str):
    boxes, labels, scores = detections
    with pathmgr.open(filename, "w") as f:
        for key in boxes.keys():
            for box, label, score in zip(boxes[key], labels[key], scores[key]):
                f.write(
                    "%s,%.03f,%.03f,%.03f,%.03f,%d,%.04f\n"
                    % (key, box[1], box[0], box[3], box[2], label, score)
                )
    logger.info("AVA results wrote to %s", filename)


def evaluate_ava(preds, original_boxes, metadata, excluded_keys,
                 class_whitelist, categories, groundtruth=None,
                 video_idx_to_name=None, name="latest",
                 output_dir: Optional[str] = None) -> float:
    """Full AVA eval from arrays; returns mAP@0.5
    (reference ava_eval_helper.py:131-166)."""
    start = time.time()
    detections = get_ava_eval_data(
        preds, original_boxes, metadata, class_whitelist,
        video_idx_to_name=video_idx_to_name,
    )
    if output_dir:
        import os

        write_results(detections, os.path.join(output_dir, f"detections_{name}.csv"))
        write_results(groundtruth, os.path.join(output_dir, f"groundtruth_{name}.csv"))
    results = run_evaluation(categories, groundtruth, detections, excluded_keys)
    logger.info("AVA eval done in %f seconds.", time.time() - start)
    return results["PascalBoxes_Precision/mAP@0.5IOU"]
