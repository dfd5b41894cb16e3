"""Box-link caches for AVA (counterpart of the AVA part of
``focus_tpu/utils/linkboxes/generate.py``; reference
``slowfast/utils/LinkBoxes/ava.py:20-90``): the person boxes of the AVA
CSVs linked into tracks by the SORT tracker over the keyframe grid, and
cached as a pickle of ``{video: {frame: [n, 5] xyxy + track id}}``, which
the ``Ava`` dataset reads under ``ORVIT.ENABLE``. Host numpy. The
EPIC-Kitchens caches (``boxes.h5`` / ``hand_boxes.h5``) need h5py and are
not written by the port.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Dict, Iterable, Optional, Sequence

import numpy as np

from focus_tpu_torch.utils import logging
from focus_tpu_torch.utils.linkboxes.sort import Sort

logger = logging.get_logger(__name__)

# AVA keyframe protocol constants (reference LinkBoxes/ava.py:13-19)
AVA_FPS = 30
AVA_START_SEC = 900
AVA_END_SEC = 1799
AVA_FRAMES_RANGE = range(AVA_FPS, (AVA_END_SEC - AVA_START_SEC) * AVA_FPS,
                         AVA_FPS)


def _filter_small(boxes, eps: float = 0.01) -> np.ndarray:
    """Drop degenerate detections (reference epickitchens.py:98-100)."""
    if len(boxes) == 0:
        return np.empty((0, 5))
    boxes = np.asarray(boxes, np.float64).reshape(-1, 5)
    keep = ((boxes[:, 2] - boxes[:, 0]) > eps) & (
        (boxes[:, 3] - boxes[:, 1]) > eps
    )
    return boxes[keep]


def link_video_boxes(
    frame_boxes: Dict[int, list],
    frame_ids: Optional[Iterable[int]] = None,
    pinned: Optional[Dict[int, np.ndarray]] = None,
    n_pinned: int = 0,
    small_eps: float = 0.01,
) -> Dict[int, np.ndarray]:
    """One video's detections ``{frame_id: [[x0, y0, x1, y1, score], ...]}``
    linked into tracks (reference epickitchens.py:101-123
    ``get_vid_boxes_linked``), over ``frame_ids`` (default: the frames that
    have boxes, sorted). ``pinned`` rows ``{frame_id: [n_pinned, 5]}``
    (hands) are prepended with the fixed ids 0..n_pinned-1; ``n_pinned``
    reserves those ids even without ``pinned`` (SORT emits id + 1, so
    tracks take ids above n_pinned). Returns ``{frame_id: [m, 5]}`` xyxy +
    track id."""
    tracker = Sort(trackers_count_start=n_pinned)
    out: Dict[int, np.ndarray] = {}
    ids = sorted(frame_boxes.keys()) if frame_ids is None else list(frame_ids)
    for fid in ids:
        boxes = _filter_small(frame_boxes.get(fid, []), small_eps)
        linked = tracker.update(boxes)
        if n_pinned > 0 and pinned is not None:
            rows = np.asarray(
                pinned.get(fid, np.zeros((n_pinned, 5))), np.float64
            ).reshape(n_pinned, 5)
            pin = np.concatenate(
                [rows[:, :4], np.arange(n_pinned, dtype=np.float64)[:, None]],
                axis=1,
            )
            linked = np.concatenate([pin, linked], axis=0)
        out[fid] = linked
    return out


def gen_ava_boxes_dict(
    csv_paths: Sequence[str], is_gt: bool
) -> Dict[str, Dict[int, list]]:
    """AVA box CSVs -> ``{video: {frame: [[x1, y1, x2, y2, score]]}}``
    (reference ava.py:28-46): second s is frame (s - 900) * 30; ground
    truth scores 1, detections their column 8."""
    dboxes: Dict[str, Dict[int, list]] = {}
    if isinstance(csv_paths, str):
        csv_paths = [csv_paths]
    for path in csv_paths:
        with open(path) as f:
            rows = f.read().split("\n")
        for line in rows:
            if not line:
                continue
            parts = line.split(",")
            vid, sec = parts[0], parts[1]
            x1, y1, x2, y2 = map(float, parts[2:6])
            score = 1.0 if is_gt else float(parts[7])
            fid = (int(sec) - AVA_START_SEC) * AVA_FPS
            dboxes.setdefault(vid, {}).setdefault(fid, []).append(
                [x1, y1, x2, y2, score]
            )
    return dboxes


def get_ava_boxes(
    csv_paths: Sequence[str],
    cache_dir: str = "run_files/linked_boxes",
    is_gt: bool = True,
) -> Dict[str, Dict[int, np.ndarray]]:
    """AVA person boxes linked over the keyframe grid, through a pickle
    cache in ``cache_dir`` (reference ava.py:80-97). ``is_gt`` says which
    list the paths came from (ground truth rows carry a person id in column
    7, detections a score). The cache's name holds each CSV's path, mtime,
    size and ``is_gt``, so an edited input makes a new cache."""
    if isinstance(csv_paths, str):
        csv_paths = [csv_paths]
    fp = hashlib.sha1()
    for p in sorted(csv_paths):
        st = os.stat(p)
        fp.update(f"{p}:{st.st_mtime_ns}:{st.st_size}:{is_gt}".encode())
    name = (
        "_".join(os.path.basename(p) for p in sorted(csv_paths))
        + "." + fp.hexdigest()[:12]
    )
    os.makedirs(cache_dir, exist_ok=True)
    out_path = os.path.join(cache_dir, name)
    if not os.path.exists(out_path):
        logger.info(f"generating linked AVA boxes -> {out_path}")
        dboxes = gen_ava_boxes_dict(csv_paths, is_gt)
        linked = {
            vid: link_video_boxes(
                frames, frame_ids=AVA_FRAMES_RANGE, small_eps=0.0
            )
            for vid, frames in dboxes.items()
        }
        with open(out_path, "wb") as f:
            pickle.dump(linked, f)
    with open(out_path, "rb") as f:
        return pickle.load(f)
