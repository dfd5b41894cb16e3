"""On-disk dataset trees and config bridging for the port's data and
engine tests: an EPIC-Kitchens tree (a pandas pickle of records, the
``rgb_frames`` JPEGs, ``boxes.h5`` and ``hand_boxes.h5``), the SSv2
``bbox_jsons`` of the annotated box format beside ``make_ssv2_tree``'s
tree, and the JAX package's config holding the same values as a port
config."""

import copy
import json
import os

import numpy as np
from PIL import Image

# (narration id, participant, video, start, stop, verb, noun): "P01_01"
# runs at 60 fps, "P02_101" at 50 (three digits after the underscore)
EK_RECORDS = (
    ("P01_01_0", "P01", "P01_01", "00:00:01.00", "00:00:02.50", 3, 17),
    ("P02_101_4", "P02", "P02_101", "00:00:00.40", "00:00:02.00", 41, 250),
)


def _fps(video):
    return 50 if len(video.split("_")[1]) == 3 else 60


def _frame(timestamp, fps):
    h, m, s = timestamp.split(":")
    sec = int(h) * 3600 + int(m) * 60 + int(s.split(".")[0]) + int(
        s.split(".")[1]) / 100
    return int(round(sec * fps))


def make_ek_tree(root, height=48, width=64, list_name="EPIC_test.pkl"):
    """EPIC-Kitchens tree under ``root``; returns (annotations dir, list
    file name, visual data dir). Boxes are normalised xyxy + a track id:
    object tracks on every other frame (ids 2-6, some degenerate), hands
    (ids 0, 1, and 2, which the reader drops) on every third."""
    import h5py
    import pandas as pd

    rs = np.random.RandomState(0)
    visual = os.path.join(root, "visual")
    ann = os.path.join(root, "annotations")
    os.makedirs(ann, exist_ok=True)
    rows = []
    with h5py.File(os.path.join(visual_mkdir(visual), "boxes.h5"), "w") as fb, \
            h5py.File(os.path.join(visual, "hand_boxes.h5"), "w") as fh:
        for nid, part, video, start, stop, verb, noun in EK_RECORDS:
            rows.append({"narration_id": nid, "participant_id": part,
                         "video_id": video, "start_timestamp": start,
                         "stop_timestamp": stop, "verb_class": verb,
                         "noun_class": noun})
            fdir = os.path.join(visual, part, "rgb_frames", video)
            os.makedirs(fdir, exist_ok=True)
            fps = _fps(video)
            for i in range(_frame(start, fps), _frame(stop, fps) + 1):
                Image.fromarray(
                    rs.randint(0, 255, (height, width, 3), np.uint8)
                ).save(os.path.join(fdir, f"frame_{i:010d}.jpg"))
                if i % 2 == 0:
                    n = rs.randint(1, 5)
                    xy = rs.rand(n, 2) * 0.6
                    wh = rs.rand(n, 2) * 0.4 - 0.05
                    ids = rs.randint(2, 7, (n, 1))
                    fb.create_dataset(
                        f"{video}/{i}",
                        data=np.concatenate([xy, xy + wh, ids], axis=1))
                if i % 3 == 0:
                    xy = rs.rand(3, 2) * 0.5
                    fh.create_dataset(
                        f"{video}/{i}",
                        data=np.concatenate(
                            [xy, xy + 0.3, [[0], [1], [2]]], axis=1))
    pd.DataFrame(rows).set_index("narration_id").to_pickle(
        os.path.join(ann, list_name))
    return ann, list_name, visual


def visual_mkdir(path):
    os.makedirs(path, exist_ok=True)
    return path


def write_ssv2_bbox_jsons(root, num_videos=3, num_frames=12, size=48):
    """GT boxes for ``make_ssv2_tree``'s videos in the annotated format:
    ``bbox_jsons/<id>.json``, a list of frames with named labels (a hand
    and up to three objects; some frames without labels)."""
    rs = np.random.RandomState(1)
    os.makedirs(os.path.join(root, "bbox_jsons"), exist_ok=True)
    for v in range(num_videos):
        vid = 10000 + v
        frames = []
        for t in range(num_frames):
            labels = []
            for cat in ("hand", "cup", "lid", "spoon")[: rs.randint(0, 5)]:
                x1, y1 = rs.rand(2) * size / 2
                labels.append({"standard_category": cat,
                               "box2d": {"x1": x1, "y1": y1,
                                         "x2": x1 + size / 3,
                                         "y2": y1 + size / 4}})
            frames.append({"name": f"{vid}/{t + 1:04d}.jpg",
                           "labels": labels})
        with open(os.path.join(root, "bbox_jsons", f"{vid}.json"), "w") as f:
            json.dump(frames, f)


def jax_cfg_like(cfg):
    """The JAX package's config with every value of the port config
    ``cfg`` (the two share one schema)."""
    from focus_tpu.config import get_cfg

    def copy_into(src, dst):
        for k, v in src.items():
            if isinstance(v, dict):
                copy_into(v, dst[k])
            else:
                dst[k] = copy.deepcopy(v)

    jcfg = get_cfg()
    copy_into(cfg, jcfg)
    return jcfg
