"""AVA frame-level mAP under the official protocol (counterpart of
``focus_tpu/utils/ava_eval.py``; numpy only, nothing here touches the
card).

PASCAL-VOC average precision per action class at IoU 0.5 between the
predicted and the ground-truth person boxes, averaged over the classes
present in the ground truth. The protocol's pieces (reference
``ava_eval_helper.py:49-289``): ``video,%04d`` image keys, excluded
timestamps (EXCLUSION_FILE), the labelmap's class whitelist
(LABEL_MAP_FILE) and the ground truth read from the official CSV
(GROUNDTRUTH_FILE), so a computed mAP is comparable to published ones.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np


def make_image_key(video_id, timestamp) -> str:
    """(reference ava_eval_helper.py:49-51)"""
    return "%s,%04d" % (video_id, int(timestamp))


def read_exclusions(path) -> set:
    """CSV of video-id,timestamp rows -> set of excluded image keys
    (reference ava_eval_helper.py:92-106)."""
    excluded = set()
    if path and os.path.exists(path):
        with open(path) as f:
            for line in f.read().splitlines():
                if not line.strip():
                    continue
                row = line.split(",")
                assert len(row) == 2, f"Expected 2 columns, got: {row}"
                excluded.add(make_image_key(row[0], row[1]))
    return excluded


def read_labelmap(path):
    """pbtxt-style labelmap -> (categories, class_id whitelist)
    (reference ava_eval_helper.py:109-124)."""
    labelmap, class_ids = [], set()
    name = ""
    if path and os.path.exists(path):
        with open(path) as f:
            for line in f:
                if line.startswith("  name:"):
                    name = line.split('"')[1]
                elif line.startswith("  id:") or line.startswith("  label_id:"):
                    class_id = int(line.strip().split(" ")[-1])
                    labelmap.append({"id": class_id, "name": name})
                    class_ids.add(class_id)
    return labelmap, class_ids


def read_csv(path, class_whitelist=None, load_score=False):
    """Official AVA CSV -> ({key: [y1,x1,y2,x2] boxes}, {key: labels},
    {key: scores}) (reference ava_eval_helper.py:54-89)."""
    boxes = defaultdict(list)
    labels = defaultdict(list)
    scores = defaultdict(list)
    with open(path) as f:
        for line in f.read().splitlines():
            if not line.strip():
                continue
            row = line.split(",")
            assert len(row) in (7, 8), f"Wrong number of columns: {row}"
            key = make_image_key(row[0], row[1])
            x1, y1, x2, y2 = (float(n) for n in row[2:6])
            action_id = int(row[6]) if row[6] != "" else -1
            if class_whitelist and action_id not in class_whitelist:
                continue
            score = float(row[7]) if load_score and len(row) == 8 else 1.0
            boxes[key].append([y1, x1, y2, x2])
            labels[key].append(action_id)
            scores[key].append(score)
    return boxes, labels, scores


def get_ava_mini_groundtruth(full_groundtruth):
    """Subset with second % 4 == 0, for fast val during training
    (reference meters.py:32-47)."""
    ret = [defaultdict(list), defaultdict(list), defaultdict(list)]
    for i in range(3):
        for key in full_groundtruth[i]:
            if int(key.split(",")[1]) % 4 == 0:
                ret[i][key] = full_groundtruth[i][key]
    return ret


def run_evaluation(categories, groundtruth, detections, excluded_keys):
    """Key-dict protocol evaluation (reference ava_eval_helper.py:174-245):
    drop excluded timestamps from both sides, then per-class VOC AP at
    IoU 0.5 over the labelmap categories. groundtruth/detections are
    (boxes, labels[, scores]) dicts keyed by image key with boxes in
    [y1, x1, y2, x2]."""
    gt_boxes, gt_labels = groundtruth[0], groundtruth[1]
    det_boxes, det_labels, det_scores = detections

    gt_rows = []
    for key in gt_boxes:
        if key in excluded_keys:
            continue
        gt_rows.append(
            (key, np.asarray(gt_boxes[key], np.float64),
             np.asarray(gt_labels[key], np.int64))
        )
    det_rows = []
    for key in det_boxes:
        if key in excluded_keys:
            continue
        det_rows.append(
            (key, np.asarray(det_boxes[key], np.float64),
             np.asarray(det_labels[key], np.int64),
             np.asarray(det_scores[key], np.float64))
        )
    result = evaluate_ava_map(
        det_rows, gt_rows, num_classes=max(
            [c["id"] for c in categories], default=0
        )
    )
    metrics = {"PascalBoxes_Precision/mAP@0.5IOU": result["map"]}
    names = {c["id"]: c["name"] for c in categories}
    for c, ap in result["ap_per_class"].items():
        metrics[
            f"PascalBoxes_PerformanceByCategory/AP@0.5IOU/{names.get(c, c)}"
        ] = ap
    metrics["map"] = result["map"]
    metrics["ap_per_class"] = result["ap_per_class"]
    return metrics


def evaluate_ava(
    preds, original_boxes, metadata, excluded_keys, class_whitelist,
    categories, groundtruth=None, video_idx_to_name=None, name="latest",
):
    """Array-path evaluation mirroring reference ava_eval_helper.py:137-171.

    preds: [N, C] scores; original_boxes: [N, 5] with a leading batch/box
    column then x1,y1,x2,y2 normalised; metadata: [N, 2] (video_idx, sec).
    """
    det_boxes = defaultdict(list)
    det_labels = defaultdict(list)
    det_scores = defaultdict(list)
    preds = np.asarray(preds)
    original_boxes = np.asarray(original_boxes)
    metadata = np.asarray(metadata)
    for i in range(preds.shape[0]):
        vidx = int(np.round(metadata[i][0]))
        sec = int(np.round(metadata[i][1]))
        video = video_idx_to_name[vidx]
        key = make_image_key(video, sec)
        x1, y1, x2, y2 = original_boxes[i][1:5]
        box = [y1, x1, y2, x2]
        for cls_idx, score in enumerate(preds[i]):
            if not class_whitelist or (cls_idx + 1) in class_whitelist:
                det_boxes[key].append(box)
                det_labels[key].append(cls_idx + 1)
                det_scores[key].append(float(score))
    metrics = run_evaluation(
        categories, groundtruth, (det_boxes, det_labels, det_scores),
        excluded_keys,
    )
    return metrics["PascalBoxes_Precision/mAP@0.5IOU"]


def _iou(box, boxes):
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    a1 = (box[2] - box[0]) * (box[3] - box[1])
    a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a1 + a2 - inter, 1e-10)


def _voc_ap(rec, prec):
    """All-points interpolated AP (VOC 2010+ / COCO style)."""
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluate_ava_map(
    detections: List[Tuple[str, np.ndarray, np.ndarray, np.ndarray]],
    groundtruth: List[Tuple[str, np.ndarray, np.ndarray]],
    num_classes: int,
    iou_thresh: float = 0.5,
) -> Dict[str, float]:
    """detections: list of (image_key, boxes [N,4], scores [N,C] or
    per-class, labels implicit as columns); here each det entry is
    (key, boxes, class_ids, scores) with flat per-(box,class) rows.
    groundtruth: (key, boxes, class_ids).
    Returns {'map': value, 'ap_per_class': dict}."""
    gt_by_class: Dict[int, Dict[str, np.ndarray]] = defaultdict(dict)
    npos = defaultdict(int)
    for key, boxes, classes in groundtruth:
        for c in np.unique(classes):
            sel = boxes[classes == c]
            gt_by_class[int(c)][key] = sel
            npos[int(c)] += len(sel)

    det_by_class: Dict[int, List] = defaultdict(list)
    for key, boxes, classes, scores in detections:
        for b, c, s in zip(boxes, classes, scores):
            det_by_class[int(c)].append((key, float(s), b))

    aps = {}
    for c, n_gt in npos.items():
        if n_gt == 0:
            continue
        dets = sorted(det_by_class.get(c, []), key=lambda r: -r[1])
        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        used: Dict[str, np.ndarray] = {}
        for i, (key, score, box) in enumerate(dets):
            gts = gt_by_class[c].get(key)
            if gts is None or len(gts) == 0:
                fp[i] = 1
                continue
            if key not in used:
                used[key] = np.zeros(len(gts), bool)
            ious = _iou(np.asarray(box), gts)
            j = int(np.argmax(ious))
            if ious[j] >= iou_thresh and not used[key][j]:
                tp[i] = 1
                used[key][j] = True
            else:
                fp[i] = 1
        rec = np.cumsum(tp) / n_gt
        prec = np.cumsum(tp) / np.maximum(np.cumsum(tp) + np.cumsum(fp), 1e-10)
        aps[c] = _voc_ap(rec, prec)

    mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
    return {"map": mean_ap, "ap_per_class": aps}


def run_evaluation_from_buffers(
    all_preds, all_ori_boxes, all_masks, all_keys, num_classes,
    score_thresh: float = 0.0, groundtruth=None,
):
    """Convert buffered eval batches ([B,O,C] scores, [B,O,4] boxes,
    [B,O] masks, [B] keys) into detection rows and score against
    groundtruth (same row format)."""
    detections = []
    for preds, boxes, mask, key in zip(
        all_preds, all_ori_boxes, all_masks, all_keys
    ):
        valid = mask > 0
        b = boxes[valid]
        p = preds[valid]
        rows_boxes, rows_cls, rows_scores = [], [], []
        for bi in range(len(b)):
            for c in range(num_classes):
                if p[bi, c] > score_thresh:
                    rows_boxes.append(b[bi])
                    rows_cls.append(c + 1)
                    rows_scores.append(p[bi, c])
        if rows_boxes:
            detections.append(
                (key, np.asarray(rows_boxes), np.asarray(rows_cls),
                 np.asarray(rows_scores))
            )
    return evaluate_ava_map(detections, groundtruth or [], num_classes)
