"""Charades multi-label frame dataset and ImageNet (counterpart of
``focus_tpu/datasets/charades.py``).

Charades: a CSV of per-frame rows (video, frame path, the frame's labels);
train samples one clip, val one clip under the video's labels, test
enumerates NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS views; the label is
multi-hot over MODEL.NUM_CLASSES, the union over the sampled frames
(video-level outside train). Frames are read by
``datasets/utils.retry_load_images`` (PIL), looked up at every read. Under
the multigrid short cycle an index comes as (index, phase), cropped as
SSv2's (``utils.multigrid_train_crop``); the JAX dataset indexes its lists
with the tuple and raises (ROADMAP.md section 3, defect 8).

ImageNet: ``root/<split>/<class>/<image>``, each image read by
``read_image`` (PIL), looked up at every read; one [H, W, C] frame an item.
"""

from __future__ import annotations

import os
from itertools import chain

import numpy as np

from focus_tpu_torch.datasets import utils as data_utils
from focus_tpu_torch.datasets.build import DATASET_REGISTRY
from focus_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


def load_image_lists(csv_file, prefix=""):
    """Frame-list CSV (``original_video_id video_id frame_id path
    labels``): (frame paths of each video, each frame's class list)."""
    image_paths = []
    labels = []
    with open(csv_file) as f:
        header = f.readline()
        assert "original_vido_id" in header or "original_video_id" in header
        cur_video = None
        for line in f.read().splitlines():
            row = line.split()
            video_name, path, frame_labels = row[0], row[3], row[-1]
            if video_name != cur_video:
                image_paths.append([])
                labels.append([])
                cur_video = video_name
            image_paths[-1].append(os.path.join(prefix, path))
            if frame_labels != '""':
                labels[-1].append(
                    [int(x) for x in frame_labels.replace('"', "").split(",")]
                )
            else:
                labels[-1].append([])
    return image_paths, labels


@DATASET_REGISTRY.register()
class Charades:
    def __init__(self, cfg, mode, num_retries=10):
        assert mode in ["train", "val", "test"]
        self.cfg = cfg
        self.mode = mode
        self._num_retries = num_retries
        self._num_clips = (
            1 if mode in ["train", "val"]
            else cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        )
        path_to_file = os.path.join(
            cfg.DATA.PATH_TO_DATA_DIR,
            "{}.csv".format("train" if mode == "train" else "val"),
        )
        self._paths, self._labels = load_image_lists(
            path_to_file, cfg.DATA.PATH_PREFIX
        )
        if mode != "train":
            # video-level labels: the union of the frames' labels
            self._labels = [
                [sorted({x for fl in video for x in fl})] * len(video)
                for video in self._labels
            ]
        self._paths = list(
            chain.from_iterable([[x] * self._num_clips for x in self._paths])
        )
        self._labels = list(
            chain.from_iterable([[x] * self._num_clips for x in self._labels])
        )
        self._spatial_temporal_idx = list(
            chain.from_iterable(
                [range(self._num_clips)
                 for _ in range(len(self._paths) // self._num_clips)]
            )
        )
        logger.info(f"Charades {mode}: {len(self._paths)} clips")

    def __len__(self):
        return len(self._paths)

    def get_seq_frames(self, index, rng):
        """The clip's frame indices: a random start (train and val) or the
        view's evenly spaced one, NUM_FRAMES frames SAMPLING_RATE apart,
        clipped to the video."""
        cfg = self.cfg
        temporal_idx = (
            -1 if self.mode in ["train", "val"]
            else self._spatial_temporal_idx[index] // cfg.TEST.NUM_SPATIAL_CROPS
        )
        num_frames = cfg.DATA.NUM_FRAMES
        sampling_rate = data_utils.get_random_sampling_rate(
            cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE, cfg.DATA.SAMPLING_RATE,
            rng,
        )
        video_length = len(self._paths[index])
        clip_length = (num_frames - 1) * sampling_rate + 1
        if temporal_idx == -1:
            if clip_length > video_length:
                start = rng.randint(0, max(video_length - clip_length, 0) + 1)
            else:
                start = rng.randint(0, video_length - clip_length + 1)
        else:
            gap = max(video_length - clip_length, 0) / max(
                cfg.TEST.NUM_ENSEMBLE_VIEWS - 1, 1
            )
            start = int(round(gap * temporal_idx))
        return [
            min(start + i * sampling_rate, video_length - 1)
            for i in range(num_frames)
        ]

    def __getitem__(self, index):
        cfg = self.cfg
        index, phase = data_utils.split_short_cycle_index(index)
        rng = np.random.RandomState(None if self.mode == "train" else index)
        seq = self.get_seq_frames(index, rng)
        frames = np.stack(
            data_utils.retry_load_images(
                [self._paths[index][i] for i in seq], self._num_retries
            )
        )
        if self.mode in ["train", "val"]:
            spatial_idx = -1
            min_scale, max_scale = cfg.DATA.TRAIN_JITTER_SCALES
            min_scale, crop_size = data_utils.multigrid_train_crop(
                cfg, phase, min_scale, cfg.DATA.TRAIN_CROP_SIZE)
        else:
            spatial_idx = (
                self._spatial_temporal_idx[index] % cfg.TEST.NUM_SPATIAL_CROPS
            )
            min_scale = max_scale = crop_size = cfg.DATA.TEST_CROP_SIZE
        frames = data_utils.maybe_normalize(frames, cfg)
        frames = data_utils.spatial_sampling(
            frames, spatial_idx=spatial_idx, min_scale=min_scale,
            max_scale=max_scale, crop_size=crop_size,
            random_horizontal_flip=cfg.DATA.RANDOM_FLIP,
            inverse_uniform_sampling=cfg.DATA.INV_UNIFORM_SAMPLE, rng=rng,
        )
        label = np.zeros(cfg.MODEL.NUM_CLASSES, np.int32)
        for i in seq:
            for x in self._labels[index][i]:
                label[x] = 1
        pathways = data_utils.pack_pathway_output(cfg, frames)
        videos = pathways[0] if len(pathways) == 1 else tuple(pathways)
        return videos, label, np.int32(index), {}


def read_image(path: str) -> np.ndarray:
    """An image file as [H, W, 3] uint8 RGB (PIL, imported here)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


@DATASET_REGISTRY.register()
class Imagenet:
    """Image classification (MViT's ImageNet pretraining); test reads the
    val split."""

    def __init__(self, cfg, mode, num_retries=10):
        assert mode in ["train", "val", "test"]
        self.cfg = cfg
        self.mode = "val" if mode == "test" else mode
        root = os.path.join(cfg.DATA.PATH_TO_DATA_DIR, self.mode)
        classes = sorted(os.listdir(root)) if os.path.isdir(root) else []
        self._items = []
        for li, cls in enumerate(classes):
            for f in sorted(os.listdir(os.path.join(root, cls))):
                self._items.append((os.path.join(root, cls, f), li))
        logger.info(f"ImageNet {mode}: {len(self._items)} images")

    def __len__(self):
        return len(self._items)

    def __getitem__(self, index):
        cfg = self.cfg
        rng = np.random.RandomState(None if self.mode == "train" else index)
        path, label = self._items[index]
        frames = read_image(path)[None]  # [1, H, W, C]
        frames = data_utils.maybe_normalize(frames, cfg)
        if self.mode == "train":
            frames = data_utils.spatial_sampling(
                frames, spatial_idx=-1,
                min_scale=cfg.DATA.TRAIN_JITTER_SCALES[0],
                max_scale=cfg.DATA.TRAIN_JITTER_SCALES[1],
                crop_size=cfg.DATA.TRAIN_CROP_SIZE, rng=rng,
            )
        else:
            frames = data_utils.spatial_sampling(
                frames, spatial_idx=1,
                min_scale=cfg.DATA.TEST_CROP_SIZE,
                max_scale=cfg.DATA.TEST_CROP_SIZE,
                crop_size=cfg.DATA.TEST_CROP_SIZE, rng=rng,
            )
        return frames[0], np.int32(label), np.int32(index), {}
