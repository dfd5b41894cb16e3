"""AVA spatio-temporal action detection (counterpart of
``focus_tpu/datasets/ava_dataset.py``; reference
``slowfast/datasets/ava_dataset.py`` and ``ava_helper.py``).

Keyframe-centric: a sample is the clip around an annotated keyframe and
that keyframe's person boxes with their multi-hot labels. The boxes are
padded to ``MAX_BOXES`` (16) with a mask in the metadata, as the JAX
package pads them, and a keyframe's boxes past the 16th are dropped, as
there (kept on purpose: the port's items equal the JAX package's). The
metadata also carries ``ori_boxes`` (the boxes in the original frame's
normalised coordinates, for the evaluator), ``video_idx``, ``sec`` and,
under ``ORVIT.ENABLE``, ``orvit_bboxes``: the SORT-linked person tracks
(``utils/linkboxes/generate.get_ava_boxes``) as O boxes a frame. The frames
are read through ``datasets/utils.retry_load_images``, looked up at each
read.
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np

from focus_tpu_torch.datasets import transform as xf, utils as data_utils
from focus_tpu_torch.datasets.build import DATASET_REGISTRY
from focus_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

AVA_VALID_FRAMES = range(902, 1799)
FPS = 30
MAX_BOXES = 16  # static per-sample box budget


def load_image_lists(cfg, is_train):
    """frame_lists CSVs: original_video_id video_id frame_id path ''
    (reference ava_helper.py:21-60). Returns (paths per video, video_idx map)."""
    lists = cfg.AVA.TRAIN_LISTS if is_train else cfg.AVA.TEST_LISTS
    image_paths = defaultdict(list)
    video_to_idx = {}
    for fname in lists:
        path = os.path.join(cfg.AVA.FRAME_LIST_DIR, fname)
        with open(path) as f:
            f.readline()  # header
            for line in f.read().splitlines():
                row = line.split()
                video = row[0]
                if video not in video_to_idx:
                    video_to_idx[video] = len(video_to_idx)
                image_paths[video_to_idx[video]].append(
                    os.path.join(cfg.AVA.FRAME_DIR, row[3])
                )
    paths = [image_paths[i] for i in range(len(video_to_idx))]
    return paths, video_to_idx


def load_boxes_and_labels(cfg, mode):
    """CSV rows video,sec,x1,y1,x2,y2,label,score (reference ava_helper.py:63-134)."""
    gt_lists = cfg.AVA.TRAIN_GT_BOX_LISTS if mode == "train" else []
    pred_lists = (
        cfg.AVA.TRAIN_PREDICT_BOX_LISTS
        if mode == "train"
        else cfg.AVA.TEST_PREDICT_BOX_LISTS
    )
    thresh = cfg.AVA.DETECTION_SCORE_THRESH
    all_boxes = {}
    for fname, is_gt in [(f, True) for f in gt_lists] + [
        (f, False) for f in pred_lists
    ]:
        path = os.path.join(cfg.AVA.ANNOTATION_DIR, fname)
        with open(path) as f:
            for line in f.read().splitlines():
                row = line.split(",")
                if not is_gt and len(row) == 8 and float(row[7]) < thresh:
                    continue
                video, sec = row[0], int(row[1])
                if sec not in AVA_VALID_FRAMES:
                    continue
                box_key = ",".join(row[2:6])
                box = list(map(float, row[2:6]))
                label = -1 if row[6] == "" else int(row[6])
                all_boxes.setdefault(video, {}).setdefault(sec, {})
                if box_key not in all_boxes[video][sec]:
                    all_boxes[video][sec][box_key] = [box, []]
                all_boxes[video][sec][box_key][1].append(label)
    out = {
        video: {
            sec: list(boxes.values()) for sec, boxes in secs.items()
        }
        for video, secs in all_boxes.items()
    }
    return out


@DATASET_REGISTRY.register()
class Ava:
    def __init__(self, cfg, split):
        self.cfg = cfg
        self._split = split
        self._sample_rate = cfg.DATA.SAMPLING_RATE
        self._video_length = cfg.DATA.NUM_FRAMES
        self._seq_len = self._video_length * self._sample_rate
        self._num_classes = cfg.MODEL.NUM_CLASSES
        self._load_data(cfg)

    def _load_data(self, cfg):
        is_train = self._split == "train"
        self._image_paths, self._video_idx_to_name = load_image_lists(
            cfg, is_train
        )
        self.orvit_boxes = None
        if cfg.ORVIT.ENABLE:
            # SORT-linked person tracks for the ORViT stream (reference
            # ava_dataset.py:89-90, ava_helper.py:240-259)
            from focus_tpu_torch.utils.linkboxes.generate import get_ava_boxes

            names = (
                cfg.AVA.TRAIN_GT_BOX_LISTS
                if is_train
                else cfg.AVA.TEST_PREDICT_BOX_LISTS
            )
            paths = [os.path.join(cfg.AVA.ANNOTATION_DIR, p) for p in names]
            self.orvit_boxes = get_ava_boxes(
                paths,
                cache_dir=os.path.join(cfg.AVA.ANNOTATION_DIR,
                                       "linked_boxes"),
                is_gt=is_train,
            )
        name_list = sorted(
            self._video_idx_to_name, key=self._video_idx_to_name.get
        ) if isinstance(self._video_idx_to_name, dict) else self._video_idx_to_name
        if isinstance(self._video_idx_to_name, dict):
            self._video_idx_to_name = name_list
        boxes_and_labels = load_boxes_and_labels(cfg, self._split)
        self._keyframes = []  # (video_idx, sec, boxes)
        for vidx, vname in enumerate(self._video_idx_to_name):
            if vname not in boxes_and_labels:
                continue
            for sec, entries in sorted(boxes_and_labels[vname].items()):
                if entries:
                    self._keyframes.append((vidx, sec, entries))
        logger.info(f"AVA {self._split}: {len(self._keyframes)} keyframes")

    def __len__(self):
        return len(self._keyframes)

    def _sec_to_frame_idx(self, sec):
        return (sec - 900) * FPS

    def __getitem__(self, index):
        cfg = self.cfg
        rng = np.random.RandomState(None if self._split == "train" else index)
        vidx, sec, entries = self._keyframes[index]
        center = self._sec_to_frame_idx(sec)
        seq = data_utils.get_sequence(
            center, self._seq_len // 2, self._sample_rate,
            len(self._image_paths[vidx]),
        )
        frames = np.stack(
            data_utils.retry_load_images(
                [self._image_paths[vidx][i] for i in seq]
            )
        )
        H, W = frames.shape[1:3]
        boxes = np.array([e[0] for e in entries], np.float32)  # normalised
        # evaluator-space boxes are captured BEFORE any preprocessing
        # (reference ava_dataset.py keeps ori_boxes in original-frame
        # normalised coordinates — the official GT CSV's space; post-crop
        # coordinates would make every IoU against the CSV wrong)
        ori_norm = np.clip(boxes.copy(), 0.0, 1.0)
        boxes[:, [0, 2]] *= W
        boxes[:, [1, 3]] *= H

        # ORViT linked tracks ride the person-box co-transform: append as
        # extra rows, split back out after aug (reference
        # ava_dataset.py:405-410, 430-448)
        n_person = len(boxes)
        orvit_T = orvit_O = 0
        if self.orvit_boxes is not None:
            # linked boxes are in AVA's normalised coordinates; bring them
            # to pixels so they co-transform with the person boxes
            ob = self._get_orvit_boxes(vidx, seq) * np.array(
                [W, H, W, H], np.float32
            )
            orvit_T, orvit_O = ob.shape[:2]
            boxes = np.concatenate(
                [boxes, ob.reshape(-1, 4).astype(np.float32)], axis=0
            )
        # multi-hot labels per box
        labels = np.zeros((len(entries), self._num_classes), np.int32)
        for i, (_, ls) in enumerate(entries):
            for l in ls:
                if 0 < l <= self._num_classes:
                    labels[i, l - 1] = 1

        # reference op order (_images_and_boxes_preprocessing,
        # ava_dataset.py:280-352): /255, geometric aug, color aug, mean/std
        frames = frames.astype(np.float32) / 255.0
        if cfg.AVA.BGR:
            # keep BGR channel order (Caffe2-zoo checkpoints; reference
            # ava_dataset.py:244-246 skips the BGR->RGB conversion —
            # our loader yields RGB, so honoring BGR means reversing)
            frames = frames[..., ::-1]
        if self._split == "train":
            frames, boxes = xf.random_short_side_scale_jitter(
                frames, cfg.DATA.TRAIN_JITTER_SCALES[0],
                cfg.DATA.TRAIN_JITTER_SCALES[1], rng, boxes=boxes,
            )
            frames, boxes = xf.random_crop(
                frames, cfg.DATA.TRAIN_CROP_SIZE, rng, boxes=boxes
            )
            if cfg.DATA.RANDOM_FLIP:
                frames, boxes = xf.horizontal_flip(frames, 0.5, rng, boxes=boxes)
        else:
            frames, boxes = xf.random_short_side_scale_jitter(
                frames, cfg.DATA.TEST_CROP_SIZE, cfg.DATA.TEST_CROP_SIZE, rng,
                boxes=boxes,
            )
            if cfg.AVA.CENTER_CROP_TEST:
                frames, boxes = xf.uniform_crop(
                    frames, cfg.DATA.TEST_CROP_SIZE, 1, boxes=boxes
                )
            if cfg.AVA.TEST_FORCE_FLIP:
                # (reference ava_dataset.py:172-192)
                frames, boxes = xf.horizontal_flip(
                    frames, 1.0, rng, boxes=boxes
                )
        if self._split == "train" and cfg.AVA.TRAIN_USE_COLOR_AUGMENTATION:
            # (reference ava_dataset.py:333-347)
            if not cfg.AVA.TRAIN_PCA_JITTER_ONLY:
                frames = xf.color_jitter(
                    frames, rng, img_brightness=0.4, img_contrast=0.4,
                    img_saturation=0.4,
                )
            frames = xf.lighting_jitter(
                frames, 0.1, cfg.DATA.TRAIN_PCA_EIGVAL,
                cfg.DATA.TRAIN_PCA_EIGVEC, rng,
            )
        frames = xf.color_normalization(frames, cfg.DATA.MEAN, cfg.DATA.STD)
        h, w = frames.shape[1:3]
        boxes = xf.clip_boxes_to_image(boxes, h, w)

        orvit_bboxes = None
        if self.orvit_boxes is not None:
            ob = boxes[n_person:].reshape(orvit_T, orvit_O, 4)
            boxes = boxes[:n_person]
            ob = ob / np.array([w, h, w, h], np.float32)
            # xyxy -> cxcywh, empties zeroed (reference :441-448)
            cxy = np.empty_like(ob)
            cxy[..., 0] = (ob[..., 0] + ob[..., 2]) / 2
            cxy[..., 1] = (ob[..., 1] + ob[..., 3]) / 2
            cxy[..., 2] = ob[..., 2] - ob[..., 0]
            cxy[..., 3] = ob[..., 3] - ob[..., 1]
            from focus_tpu_torch.utils.box_ops import zero_empty_boxes_np

            orvit_bboxes = zero_empty_boxes_np(cxy, "cxcywh").astype(
                np.float32
            )

        # pad to static MAX_BOXES
        n = min(len(boxes), MAX_BOXES)
        padded = np.zeros((MAX_BOXES, 4), np.float32)
        padded_labels = np.zeros((MAX_BOXES, self._num_classes), np.int32)
        mask = np.zeros((MAX_BOXES,), np.float32)
        padded[:n] = boxes[:n]
        padded_labels[:n] = labels[:n]
        mask[:n] = 1.0
        # original-frame normalised boxes for the evaluator
        ori = np.zeros((MAX_BOXES, 4), np.float32)
        ori[:n] = ori_norm[:n]
        metadata = {
            "boxes": padded,
            "boxes_mask": mask,
            "ori_boxes": ori,
            "video_idx": np.int32(vidx),
            "sec": np.int32(sec),
        }
        if orvit_bboxes is not None:
            metadata["orvit_bboxes"] = orvit_bboxes
        pathways = data_utils.pack_pathway_output(cfg, frames)
        videos = pathways[0] if len(pathways) == 1 else tuple(pathways)
        return videos, padded_labels, np.int32(index), metadata

    def _get_orvit_boxes(self, video_idx, seq):
        """Linked tracks -> fixed-O per-frame boxes in pixel coordinates
        (reference ava_dataset.py:461-504 ``get_orvit_boxes_provided``)."""
        from focus_tpu_torch.utils.linkboxes.generate import AVA_FPS

        O = self.cfg.ORVIT.O
        vid = self._video_idx_to_name[video_idx]
        vboxes = self.orvit_boxes.get(vid, {})
        # the linked dict is keyed on the keyframe grid (whole seconds);
        # snap each clip frame to its keyframe, clamped to the valid AVA
        # keyframe range [2s, 898s] so frames near the video start/end
        # map to real keys instead of silently yielding no boxes
        # (reference round_frame, ava_dataset.py:541-548: MINF/MAXF)
        minf, maxf = 2 * AVA_FPS, 898 * AVA_FPS
        keys = [
            min(max(int(round(f / AVA_FPS)) * AVA_FPS, minf), maxf)
            for f in seq
        ]
        rows = [np.asarray(vboxes.get(k, np.empty((0, 5)))) for k in keys]
        global2local: dict = {}

        def getidx(g):
            if g not in global2local:
                global2local[g] = len(global2local)
            return global2local[g]

        T = len(seq)
        out = np.zeros((T, O, 4), np.float32)
        for fidx, boxes in enumerate(rows):
            boxes = boxes.reshape(-1, 5)
            for row in boxes:
                slot = getidx(int(row[4]))
                if slot < O:
                    out[fidx, slot] = row[:4]
        return out
