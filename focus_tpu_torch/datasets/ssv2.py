"""Something-Something V2 frame dataset (counterpart of
``focus_tpu/datasets/ssv2.py``, whose PIL path it ports: the JAX package's
libjpeg decoder, ``focus_tpu/native/``, is not ported).

Frame JPEGs with segment-based temporal sampling; ORViT box loading from
detectron2-detected ``.npy`` per-frame boxes (hands pinned to slots 0-1,
objects from slot 2; reference ssv2.py:557-599) or GT ``bbox_jsons``
(:478-548). Returns (pathways, label, index, metadata) with
``metadata['orvit_bboxes']`` as normalised cxcywh, empty boxes zeroed.
Training takes RandAugment (``AUG.ENABLE``, ``datasets/rand_augment.py``,
boxes moved with the frames) before the normalisation, then the scale
jitter, the random crop and the flip; the train mode's generator is
unseeded, as the JAX package's.
"""

from __future__ import annotations

import json
import os
from itertools import chain

import numpy as np

from focus_tpu_torch.datasets import transform as xf
from focus_tpu_torch.datasets import utils as data_utils
from focus_tpu_torch.datasets.build import DATASET_REGISTRY
from focus_tpu_torch.datasets.rand_augment import rand_augment_video
from focus_tpu_torch.utils import logging
from focus_tpu_torch.utils.box_ops import zero_empty_boxes_np

logger = logging.get_logger(__name__)


def _xyxy_to_cxcywh_np(b):
    out = b.copy()
    out[..., 0] = (b[..., 0] + b[..., 2]) / 2
    out[..., 1] = (b[..., 1] + b[..., 3]) / 2
    out[..., 2] = b[..., 2] - b[..., 0]
    out[..., 3] = b[..., 3] - b[..., 1]
    return out


@DATASET_REGISTRY.register()
class Ssv2:
    def __init__(self, cfg, mode, num_retries=10):
        assert mode in ["train", "val", "test"]
        self.cfg = cfg
        self.mode = mode
        self.data_root = cfg.SSV2.DATA_ROOT
        self.splits_root = cfg.SSV2.SPLITS_ROOT
        self._num_retries = num_retries
        self._num_clips = (
            1 if mode in ["train", "val"]
            else cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        )
        self._construct_loader()
        self.aug = mode == "train" and cfg.AUG.ENABLE

    def _construct_loader(self):
        split = self.cfg.SSV2.SPLIT
        data_split = self.mode
        if split == "compositional":
            file_labels = os.path.join(
                self.splits_root, "dataset_splits/compositional/labels.json"
            )
            label_file = os.path.join(
                self.splits_root,
                "dataset_splits/compositional/"
                f'{"train" if data_split == "train" else "validation"}.json',
            )
        elif split == "standard":
            file_labels = (
                f"{self.data_root}/sm/annotations/"
                "something-something-v2-labels.json"
            )
            label_file = (
                f"{self.data_root}/json_files/something-something-v2-"
                f'{"train" if data_split == "train" else "validation"}.json'
            )
        else:
            raise NotImplementedError(f"split = {split}")

        with open(file_labels) as f:
            label_dict = json.load(f)
        with open(label_file) as f:
            label_json = json.load(f)
        sort_out_path = os.path.join(
            self.splits_root,
            "empty_bbox_{}.json".format(
                "train" if data_split == "train" else "val"
            ),
        )
        sort_out = set()
        if os.path.exists(sort_out_path):
            with open(sort_out_path) as f:
                sort_out = set(json.load(f))

        self._video_names, self._labels = [], []
        for video in label_json:
            if video["id"] in sort_out:
                continue
            template = video["template"].replace("[", "").replace("]", "")
            self._video_names.append(video["id"])
            self._labels.append(int(label_dict[template]))

        # replicate for multi-view testing
        self._video_names = list(
            chain.from_iterable([[x] * self._num_clips for x in self._video_names])
        )
        self._labels = list(
            chain.from_iterable([[x] * self._num_clips for x in self._labels])
        )
        self._spatial_temporal_idx = list(
            chain.from_iterable(
                [range(self._num_clips) for _ in range(len(self._labels) // self._num_clips)]
            )
        )
        logger.info(f"SSv2 {self.mode} loader: {len(self._labels)} clips")

    def __len__(self):
        return len(self._labels)

    # ---- frame / box selection -------------------------------------------

    def get_frame_path(self, vid_name, frame_idx):
        return os.path.join(
            self.data_root, "frames", vid_name, "%04d.jpg" % (frame_idx + 1)
        )

    def get_seq_frames(self, index, video_length, rng):
        """Segment-based sampling (reference ssv2.py:203-223)."""
        num_frames = self.cfg.DATA.NUM_FRAMES
        seg_size = float(video_length - 1) / num_frames
        seq = []
        for i in range(num_frames):
            start = int(np.round(seg_size * i))
            end = int(np.round(seg_size * (i + 1)))
            seq.append(rng.randint(start, end + 1) if self.mode == "train" else (start + end) // 2)
        return seq

    def get_boxes_detected(self, index, rng):
        """(reference ssv2.py:557-599)"""
        O = self.cfg.ORVIT.O
        T = self.cfg.DATA.NUM_FRAMES
        vid = self._video_names[index]
        bpath = os.path.join(self.data_root, "detected_boxes", vid)
        files = sorted(os.listdir(bpath))
        video_data = [np.load(os.path.join(bpath, f), allow_pickle=True) for f in files]
        seq = self.get_seq_frames(index, len(video_data), rng)
        frames = [self.get_frame_path(vid, fid) for fid in seq]
        box_tensors = np.zeros((T, O, 4), np.float32)
        for fi, fid in enumerate(seq):
            try:
                frame_data = video_data[fid].item()
            except (IndexError, ValueError):
                continue
            hand_idx, obj_idx = 0, 2
            for ibox in range(len(frame_data["boxes"])):
                cat = int(frame_data["pred_classes"][ibox])
                slot = hand_idx if cat == 0 else obj_idx
                if cat == 0:
                    hand_idx += 1
                else:
                    obj_idx += 1
                if slot < O:
                    box_tensors[fi, slot] = np.asarray(
                        frame_data["boxes"][ibox], np.float32
                    )
        return frames, box_tensors

    def get_boxes_gt(self, index, rng):
        """(reference ssv2.py:478-548)"""
        O = self.cfg.ORVIT.O
        T = self.cfg.DATA.NUM_FRAMES
        vid = self._video_names[index]
        json_path = os.path.join(
            self.data_root, "bbox_jsons", f"{int(vid)}.json"
        )
        with open(json_path) as f:
            video_data = json.load(f)
        seq = self.get_seq_frames(index, len(video_data), rng)
        object_set = set()
        frames = []
        for fid in seq:
            fd = video_data[fid] if fid < len(video_data) else {"labels": []}
            for box in fd.get("labels", []):
                object_set.add(box["standard_category"])
            frames.append(
                self.get_frame_path(
                    vid, int(fd["name"].split("/")[-1][:-4]) - 1
                )
                if "name" in fd else self.get_frame_path(vid, fid)
            )
        object_set = sorted(object_set)
        if "hand" in object_set:
            object_set.remove("hand")
            object_set = ["hand"] + object_set
        else:
            object_set = ["none"] + object_set
        box_tensors = np.zeros((T, O, 4), np.float32)
        for fi, fid in enumerate(seq):
            fd = video_data[fid] if fid < len(video_data) else {"labels": []}
            for box in fd.get("labels", []):
                slot = object_set.index(box["standard_category"])
                if slot < O:
                    bc = box["box2d"]
                    box_tensors[fi, slot] = [bc["x1"], bc["y1"], bc["x2"], bc["y2"]]
        return frames, box_tensors

    # ---- main -------------------------------------------------------------

    def __getitem__(self, index):
        cfg = self.cfg
        index, phase = data_utils.split_short_cycle_index(index)
        rng = np.random.RandomState(
            None if self.mode == "train" else index
        )
        if self.mode in ["train", "val"]:
            spatial_idx = -1
            min_scale, max_scale = cfg.DATA.TRAIN_JITTER_SCALES
            # multigrid short-cycle crop scaling (reference ssv2.py:245-262)
            min_scale, crop_size = data_utils.multigrid_train_crop(
                cfg, phase, min_scale, cfg.DATA.TRAIN_CROP_SIZE)
        else:
            spatial_idx = (
                self._spatial_temporal_idx[index] % cfg.TEST.NUM_SPATIAL_CROPS
            )
            if cfg.TEST.NUM_SPATIAL_CROPS == 1:
                spatial_idx = 1
            min_scale = max_scale = crop_size = cfg.DATA.TEST_CROP_SIZE

        label = self._labels[index]
        boxes = None
        if cfg.ORVIT.ENABLE:
            if cfg.SSV2.BOXES_FORMAT == "detectron2":
                fpaths, boxes = self.get_boxes_detected(index, rng)
            elif cfg.SSV2.BOXES_FORMAT == "annotated":
                fpaths, boxes = self.get_boxes_gt(index, rng)
            else:
                raise NotImplementedError(cfg.SSV2.BOXES_FORMAT)
        else:
            bpath = os.path.join(self.data_root, "frames", self._video_names[index])
            allframes = sorted(
                (f for f in os.listdir(bpath) if f.endswith("jpg")),
                key=lambda x: int(x.split(".")[0]),
            )
            seq = self.get_seq_frames(index, len(allframes), rng)
            fpaths = [os.path.join(bpath, allframes[i]) for i in seq]

        frames = np.stack(
            data_utils.retry_load_images(fpaths, self._num_retries)
        )  # [T, H, W, C] uint8

        if self.aug:
            frames, boxes = rand_augment_video(
                frames, boxes, cfg.AUG.AA_TYPE,
                different_per_frame=cfg.AUG.DIFFERENT_AUG_PER_FRAME, rng=rng,
                interpolation=cfg.AUG.INTERPOLATION,
            )

        frames = data_utils.maybe_normalize(frames, cfg)

        # joint geometric aug for frames (+ boxes)
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

        return self._finalize(frames, boxes, index)

    def _finalize(self, frames, boxes, index):
        cfg = self.cfg
        label = self._labels[index]
        if frames.dtype != np.uint8:
            frames = frames.astype(np.float32)
        pathways = data_utils.pack_pathway_output(cfg, frames)
        metadata = {}
        if boxes is not None:
            h, w = frames.shape[1:3]
            boxes = boxes.astype(np.float32)
            boxes[..., [0, 2]] /= w
            boxes[..., [1, 3]] /= h
            boxes = np.clip(boxes, 0, 1)
            boxes = _xyxy_to_cxcywh_np(boxes)
            boxes = zero_empty_boxes_np(boxes, "cxcywh")
            metadata["orvit_bboxes"] = boxes
        videos = pathways[0] if len(pathways) == 1 else tuple(pathways)
        return videos, np.int32(label), np.int32(index), metadata
