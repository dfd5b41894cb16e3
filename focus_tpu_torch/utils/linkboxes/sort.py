"""SORT, simple online realtime tracking, and pre-linked tracks to fixed
object slots (counterpart of ``focus_tpu/utils/linkboxes/sort.py``; the
reference wraps filterpy and lap).

The tracker links person boxes into tracks on the host before a dataset
reads them (``generate.get_ava_boxes``): the standard SORT 7-state
constant-velocity Kalman filter ([cx, cy, s, r, vx, vy, vs]) and IoU
association through scipy's Hungarian solver. Every track's id comes from
the tracker, counted up from ``trackers_count_start``.
"""

from __future__ import annotations

import numpy as np


def iou_batch(bb_test, bb_gt):
    """Pairwise IoU of [N,4] x [M,4] xyxy (reference sort.py:47-63)."""
    bb_gt = np.expand_dims(bb_gt, 0)
    bb_test = np.expand_dims(bb_test, 1)
    xx1 = np.maximum(bb_test[..., 0], bb_gt[..., 0])
    yy1 = np.maximum(bb_test[..., 1], bb_gt[..., 1])
    xx2 = np.minimum(bb_test[..., 2], bb_gt[..., 2])
    yy2 = np.minimum(bb_test[..., 3], bb_gt[..., 3])
    w = np.maximum(0.0, xx2 - xx1)
    h = np.maximum(0.0, yy2 - yy1)
    wh = w * h
    area_t = (bb_test[..., 2] - bb_test[..., 0]) * (bb_test[..., 3] - bb_test[..., 1])
    area_g = (bb_gt[..., 2] - bb_gt[..., 0]) * (bb_gt[..., 3] - bb_gt[..., 1])
    return wh / (area_t + area_g - wh + 1e-12)


def convert_bbox_to_z(bbox):
    w = bbox[2] - bbox[0]
    h = bbox[3] - bbox[1]
    x = bbox[0] + w / 2.0
    y = bbox[1] + h / 2.0
    s = w * h
    r = w / (h + 1e-12)
    return np.array([x, y, s, r], np.float64).reshape(4, 1)


def convert_x_to_bbox(x):
    w = np.sqrt(max(x[2, 0] * x[3, 0], 0.0))
    h = x[2, 0] / (w + 1e-12)
    return np.array(
        [x[0, 0] - w / 2.0, x[1, 0] - h / 2.0, x[0, 0] + w / 2.0, x[1, 0] + h / 2.0]
    )


class _Kalman:
    """Constant-velocity Kalman filter with SORT's standard matrices."""

    def __init__(self, z0):
        dim_x = 7
        self.x = np.zeros((dim_x, 1))
        self.x[:4] = z0
        self.F = np.eye(dim_x)
        for i in range(3):
            self.F[i, i + 4] = 1.0
        self.H = np.zeros((4, dim_x))
        self.H[:4, :4] = np.eye(4)
        self.P = np.eye(dim_x)
        self.P[4:, 4:] *= 1000.0
        self.P *= 10.0
        self.Q = np.eye(dim_x)
        self.Q[-1, -1] *= 0.01
        self.Q[4:, 4:] *= 0.01
        self.R = np.eye(4)
        self.R[2:, 2:] *= 10.0

    def predict(self):
        if self.x[6, 0] + self.x[2, 0] <= 0:
            self.x[6, 0] = 0.0
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q

    def update(self, z):
        y = z - self.H @ self.x
        S = self.H @ self.P @ self.H.T + self.R
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.x = self.x + K @ y
        self.P = (np.eye(7) - K @ self.H) @ self.P


class KalmanBoxTracker:
    """(reference sort.py:96-160)"""

    def __init__(self, bbox, id):
        self.kf = _Kalman(convert_bbox_to_z(bbox))
        self.time_since_update = 0
        # the id comes from the tracker (reference sort.py:204-249
        # trackers_count_start: link generation reserves low ids for
        # pinned slots)
        self.id = id
        self.hits = 0
        self.hit_streak = 0
        self.age = 0

    def update(self, bbox):
        self.time_since_update = 0
        self.hits += 1
        self.hit_streak += 1
        self.kf.update(convert_bbox_to_z(bbox))

    def predict(self):
        self.kf.predict()
        self.age += 1
        if self.time_since_update > 0:
            self.hit_streak = 0
        self.time_since_update += 1
        return self.get_state()

    def get_state(self):
        return convert_x_to_bbox(self.kf.x)


def associate_detections_to_trackers(detections, trackers, iou_threshold=0.3):
    """(reference sort.py:165-200)"""
    from scipy.optimize import linear_sum_assignment

    if len(trackers) == 0:
        return (
            np.empty((0, 2), int),
            np.arange(len(detections)),
            np.empty((0,), int),
        )
    iou = iou_batch(detections, trackers)
    row, col = linear_sum_assignment(-iou)
    matches = []
    for r, c in zip(row, col):
        if iou[r, c] >= iou_threshold:
            matches.append([r, c])
    matches = np.array(matches, int).reshape(-1, 2)
    unmatched_dets = np.array(
        [d for d in range(len(detections)) if d not in matches[:, 0]], int
    )
    unmatched_trks = np.array(
        [t for t in range(len(trackers)) if t not in matches[:, 1]], int
    )
    return matches, unmatched_dets, unmatched_trks


class Sort:
    """(reference sort.py:203-262)"""

    def __init__(self, max_age=1, min_hits=3, iou_threshold=0.3,
                 clear_dups_threshold=-1, trackers_count_start=0):
        self.max_age = max_age
        self.min_hits = min_hits
        self.iou_threshold = iou_threshold
        self.trackers: list[KalmanBoxTracker] = []
        self.frame_count = 0
        # ids handed to new tracks count up from here (pinned slots below)
        self.trackers_count = trackers_count_start

    def update(self, dets=np.empty((0, 5))):
        """dets: [N, 5] xyxy+score. Returns [M, 5] xyxy+track_id."""
        self.frame_count += 1
        trks = np.zeros((len(self.trackers), 5))
        to_del = []
        for t in range(len(trks)):
            pos = self.trackers[t].predict()
            trks[t] = [pos[0], pos[1], pos[2], pos[3], 0]
            if np.any(np.isnan(pos)):
                to_del.append(t)
        trks = np.ma.compress_rows(np.ma.masked_invalid(trks))
        for t in reversed(to_del):
            self.trackers.pop(t)
        matched, unmatched_dets, _ = associate_detections_to_trackers(
            dets[:, :4], trks[:, :4], self.iou_threshold
        )
        for m in matched:
            self.trackers[m[1]].update(dets[m[0], :4])
        for i in unmatched_dets:
            self.trackers.append(
                KalmanBoxTracker(dets[i, :4], id=self.trackers_count)
            )
            self.trackers_count += 1
        ret = []
        for trk in reversed(self.trackers):
            d = trk.get_state()
            if trk.time_since_update < 1 and (
                trk.hit_streak >= self.min_hits
                or self.frame_count <= self.min_hits
            ):
                ret.append(np.concatenate([d, [trk.id + 1]]))
        self.trackers = [
            t for t in self.trackers if t.time_since_update <= self.max_age
        ]
        if ret:
            return np.stack(ret)
        return np.empty((0, 5))


def sort_boxes_sorted(vid_boxes, O, saved_indices=()):
    """Pre-linked boxes [n, 5] (xyxy + track id) a frame -> [O, T, 4];
    ``saved_indices`` pin the given track ids to the first slots (hands).
    Further ids take the next slot in order of first appearance; ids past
    slot O - 1 are dropped."""
    global2local = {idx: i for i, idx in enumerate(sorted(saved_indices))}

    def getidx(g):
        if g not in global2local:
            global2local[g] = len(global2local)
        return global2local[g]

    T = len(vid_boxes)
    out = np.zeros([T, O, 4])
    for fidx, boxes in enumerate(vid_boxes):
        boxes = np.asarray(boxes, np.float64).reshape(-1, 5)
        for row in boxes:
            slot = getidx(int(row[4]))
            if slot < O:
                out[fidx, slot] = row[:4]
    return out.transpose([1, 0, 2])
