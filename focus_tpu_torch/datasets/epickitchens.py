"""EPIC-KITCHENS-100 dataset (counterpart of
``focus_tpu/datasets/epickitchens.py``).

Pandas-pickle annotation records; RGB frame JPEGs
(``P01/rgb_frames/P01_01/frame_0000000001.jpg``); verb/noun dict labels;
ORViT boxes from an h5 cache of SORT-linked detections with hands pinned
to slots 0-1 (reference ek_MF/epickitchens_record.py:107-169).
"""

from __future__ import annotations

import os
import time
from datetime import timedelta

import numpy as np

from focus_tpu_torch.datasets import decoder, transform as xf, utils as data_utils
from focus_tpu_torch.datasets.build import DATASET_REGISTRY
from focus_tpu_torch.utils import logging
from focus_tpu_torch.utils.box_ops import zero_empty_boxes_np
from focus_tpu_torch.utils.linkboxes.sort import sort_boxes_sorted

logger = logging.get_logger(__name__)


def timestamp_to_sec(timestamp: str) -> float:
    x = time.strptime(timestamp, "%H:%M:%S.%f")
    sec = float(
        timedelta(hours=x.tm_hour, minutes=x.tm_min, seconds=x.tm_sec).total_seconds()
    ) + float(timestamp.split(".")[-1]) / 100
    return sec


class EpicKitchensVideoRecord:
    """(reference ek_MF/epickitchens_record.py:24-61)"""

    def __init__(self, tup):
        self._index = str(tup[0])
        self._series = tup[1]

    @property
    def participant(self):
        return self._series["participant_id"]

    @property
    def untrimmed_video_name(self):
        return self._series["video_id"]

    @property
    def fps(self):
        return 50 if len(self.untrimmed_video_name.split("_")[1]) == 3 else 60

    @property
    def start_frame(self):
        return int(round(timestamp_to_sec(self._series["start_timestamp"]) * self.fps))

    @property
    def end_frame(self):
        return int(round(timestamp_to_sec(self._series["stop_timestamp"]) * self.fps))

    @property
    def num_frames(self):
        return self.end_frame - self.start_frame

    @property
    def label(self):
        return {
            "verb": self._series.get("verb_class", -1),
            "noun": self._series.get("noun_class", -1),
        }

    @property
    def metadata(self):
        return {"narration_id": self._index}


class EKBoxes:
    """h5-backed SORT-linked boxes, hands in slots 0-1
    (reference ek_MF/epickitchens_record.py:107-169)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.O = cfg.ORVIT.O
        root = cfg.EPICKITCHENS.VISUAL_DATA_DIR
        self.hand_boxes_path = os.path.join(root, "hand_boxes.h5")
        self.boxes_path = os.path.join(root, "boxes.h5")
        self.boxes = None
        self.hand_boxes = None

    def _open(self):
        import h5py

        if self.boxes is None:
            self.boxes = h5py.File(self.boxes_path, "r")
            if os.path.exists(self.hand_boxes_path):
                self.hand_boxes = h5py.File(self.hand_boxes_path, "r")

    def get_boxes(self, vid: str, seq):
        self._open()
        empty = np.empty([0, 5])
        boxes = [np.asarray(self.boxes[vid].get(str(i), empty)) for i in seq]
        if self.hand_boxes is not None:
            hands = [
                np.asarray(self.hand_boxes[vid].get(str(i), empty)) for i in seq
            ]
            hands = [h[h[:, -1] < 2] if len(h) else h for h in hands]
            boxes = [np.concatenate([h, b], axis=0) for h, b in zip(hands, boxes)]
        out = sort_boxes_sorted(boxes, O=self.O, saved_indices=[0, 1])
        return out.astype(np.float32)  # [O, T, 4] normalised xyxy

    @staticmethod
    def prepare_boxes(boxes):
        """[O, T, 4] -> clipped [T, O, 4] cxcywh, empties zeroed
        (reference :146-169)."""
        boxes = np.clip(boxes, 0, 1).transpose(1, 0, 2)
        out = boxes.copy()
        out[..., 0] = (boxes[..., 0] + boxes[..., 2]) / 2
        out[..., 1] = (boxes[..., 1] + boxes[..., 3]) / 2
        out[..., 2] = boxes[..., 2] - boxes[..., 0]
        out[..., 3] = boxes[..., 3] - boxes[..., 1]
        return zero_empty_boxes_np(out, "cxcywh")


@DATASET_REGISTRY.register()
class Epickitchens:
    def __init__(self, cfg, mode):
        assert mode in ["train", "val", "test", "train+val"]
        self.cfg = cfg
        self.mode = mode
        self.target_fps = cfg.DATA.TARGET_FPS
        self._num_clips = (
            1 if mode in ["train", "val", "train+val"]
            else cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        )
        self.ek_boxes = EKBoxes(cfg) if cfg.ORVIT.ENABLE else None
        self._construct_loader()

    def _construct_loader(self):
        import pandas as pd

        cfg = self.cfg
        files = {
            "train": [cfg.EPICKITCHENS.TRAIN_LIST],
            "val": [cfg.EPICKITCHENS.VAL_LIST],
            "test": [cfg.EPICKITCHENS.TEST_LIST],
            "train+val": [cfg.EPICKITCHENS.TRAIN_LIST, cfg.EPICKITCHENS.VAL_LIST],
        }[self.mode]
        self._video_records = []
        self._spatial_temporal_idx = []
        for fname in files:
            path = os.path.join(cfg.EPICKITCHENS.ANNOTATIONS_DIR, fname)
            for tup in pd.read_pickle(path).iterrows():
                for idx in range(self._num_clips):
                    self._video_records.append(EpicKitchensVideoRecord(tup))
                    self._spatial_temporal_idx.append(idx)
        logger.info(f"EK {self.mode}: {len(self._video_records)} records")

    def __len__(self):
        return len(self._video_records)

    def _pack_frames(self, record, temporal_idx, rng):
        """(reference ek_MF/frame_loader.py:31-65)"""
        cfg = self.cfg
        path_to_video = "{}/{}/rgb_frames/{}".format(
            cfg.EPICKITCHENS.VISUAL_DATA_DIR,
            record.participant,
            record.untrimmed_video_name,
        )
        start_idx, end_idx = decoder.get_start_end_idx(
            record.num_frames,
            cfg.DATA.NUM_FRAMES * cfg.DATA.SAMPLING_RATE * record.fps / self.target_fps,
            temporal_idx,
            cfg.TEST.NUM_ENSEMBLE_VIEWS,
            rng,
        )
        start_idx, end_idx = start_idx + 1, end_idx + 1
        index = np.clip(
            np.linspace(start_idx, end_idx, cfg.DATA.NUM_FRAMES),
            0, record.num_frames - 1,
        ).astype(np.int64) + record.start_frame
        paths = [
            os.path.join(path_to_video, f"frame_{int(i):010d}.jpg")
            for i in index
        ]
        return np.stack(data_utils.retry_load_images(paths)), index

    def __getitem__(self, index):
        cfg = self.cfg
        rng = np.random.RandomState(None if self.mode == "train" else index)
        if self.mode in ["train", "val", "train+val"]:
            temporal_idx, spatial_idx = -1, -1
            min_scale, max_scale = cfg.DATA.TRAIN_JITTER_SCALES
            crop_size = cfg.DATA.TRAIN_CROP_SIZE
        else:
            temporal_idx = (
                self._spatial_temporal_idx[index] // cfg.TEST.NUM_SPATIAL_CROPS
            )
            spatial_idx = (
                self._spatial_temporal_idx[index] % cfg.TEST.NUM_SPATIAL_CROPS
                if cfg.TEST.NUM_SPATIAL_CROPS == 3 else 1
            )
            min_scale = max_scale = crop_size = cfg.DATA.TEST_CROP_SIZE

        record = self._video_records[index]
        frames, seq = self._pack_frames(record, temporal_idx, rng)
        boxes = None
        if self.ek_boxes is not None:
            boxes = self.ek_boxes.get_boxes(
                record.untrimmed_video_name, seq.tolist()
            )  # [O, T, 4] normalised
            # to pixel coords for joint geometric transforms
            h, w = frames.shape[1:3]
            boxes = boxes.transpose(1, 0, 2).copy()  # [T, O, 4]
            boxes[..., [0, 2]] *= w
            boxes[..., [1, 3]] *= h

        frames = data_utils.maybe_normalize(frames, cfg)
        if spatial_idx == -1:
            out = xf.random_short_side_scale_jitter(
                frames, min_scale, max_scale, rng,
                inverse_uniform_sampling=cfg.DATA.INV_UNIFORM_SAMPLE,
                boxes=boxes,
            )
            frames, boxes = out if boxes is not None else (out, None)
            out = xf.random_crop(frames, crop_size, rng, boxes=boxes)
            frames, boxes = out if boxes is not None else (out, None)
            if cfg.DATA.RANDOM_FLIP:
                out = xf.horizontal_flip(frames, 0.5, rng, boxes=boxes)
                frames, boxes = out if boxes is not None else (out, None)
        else:
            out = xf.random_short_side_scale_jitter(
                frames, min_scale, min_scale, rng, boxes=boxes
            )
            frames, boxes = out if boxes is not None else (out, None)
            out = xf.uniform_crop(frames, crop_size, spatial_idx, boxes=boxes)
            frames, boxes = out if boxes is not None else (out, None)

        label = record.label
        labels = {
            "verb": np.int32(label["verb"]),
            "noun": np.int32(label["noun"]),
        }
        metadata = {}
        if boxes is not None:
            h, w = frames.shape[1:3]
            boxes[..., [0, 2]] /= w
            boxes[..., [1, 3]] /= h
            bt = boxes.transpose(1, 0, 2)  # [O, T, 4] for prepare
            metadata["orvit_bboxes"] = EKBoxes.prepare_boxes(bt).astype(np.float32)
        pathways = data_utils.pack_pathway_output(cfg, frames)
        videos = pathways[0] if len(pathways) == 1 else tuple(pathways)
        return videos, labels, np.int32(index), metadata
