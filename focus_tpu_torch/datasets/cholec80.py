"""Cholec80 surgical-phase dataset (counterpart of
``focus_tpu/datasets/cholec80.py``).

A pickle of per-video frame records (``Frame_id``, ``Phase_gt``); a clip is
the NUM_FRAMES records from the indexed frame backwards, latest first,
front-padded with its first record (the indexed one) where the video has
fewer, read from ``DATA.PATH_PREFIX/<video>/<Frame_id>.jpg`` by
``datasets/utils.retry_load_images`` (PIL); the label is the phase of the
clip's last record, its earliest frame. That order is the JAX package's,
kept bit for bit, although its docstring describes the clip as ending at the
indexed frame (``ROADMAP.md`` §3). Frames are normalised on the host
whatever their dtype, as the JAX package's are.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from focus_tpu_torch.datasets import utils as data_utils
from focus_tpu_torch.datasets.build import DATASET_REGISTRY
from focus_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


@DATASET_REGISTRY.register()
class Cholec80:
    def __init__(self, cfg, mode="train", num_retries=1):
        assert mode in ["train", "val", "test"]
        self.cfg = cfg
        self.mode = mode
        self._num_retries = num_retries
        pkl = {
            "train": cfg.CHOLEC.TRAIN_PKL,
            "val": cfg.CHOLEC.VAL_PKL,
            "test": cfg.CHOLEC.TEST_PKL,
        }[mode]
        self.pkl_file = os.path.join(cfg.CHOLEC.PATH, mode, pkl)
        with open(self.pkl_file, "rb") as f:
            self.data = pickle.load(f)
        self.map = {}
        self._frame_list = []
        for v in self.data:
            frame_list = self.data[v]
            self.map[v] = {
                k["Frame_id"]: i for i, k in enumerate(frame_list)
            }
            self._frame_list.extend(
                [dict(rec, _video=v) for rec in frame_list]
            )
        logger.info(
            f"Cholec80 {mode}: {len(self._frame_list)} frames from {self.pkl_file}"
        )

    def __len__(self):
        return len(self._frame_list)

    def get_seq_frames(self, index):
        """(the clip's records, latest first, and their frame paths)."""
        num_frames = self.cfg.DATA.NUM_FRAMES
        rec = self._frame_list[index]
        video_id = rec["_video"]
        end_index = self.map[video_id][rec["Frame_id"]]
        seq = []
        for k in range(end_index, -1, -1):
            seq.append(self.data[video_id][k])
            if len(seq) == num_frames:
                break
        if len(seq) < num_frames:
            seq = [seq[0]] * (num_frames - len(seq)) + seq
        paths = [
            os.path.join(
                self.cfg.DATA.PATH_PREFIX, video_id, f"{r['Frame_id']}.jpg"
            )
            for r in seq
        ]
        return seq, paths

    def __getitem__(self, index):
        cfg = self.cfg
        rng = np.random.RandomState(None if self.mode == "train" else index)
        if self.mode in ["train", "val"]:
            spatial_idx = -1
            min_scale, max_scale = cfg.DATA.TRAIN_JITTER_SCALES
            crop_size = cfg.DATA.TRAIN_CROP_SIZE
        else:
            spatial_idx = 1
            min_scale = max_scale = crop_size = cfg.DATA.TEST_CROP_SIZE
        seq, paths = self.get_seq_frames(index)
        frames = np.stack(
            data_utils.retry_load_images(paths, self._num_retries)
        )
        frames = data_utils.tensor_normalize(frames, cfg.DATA.MEAN, cfg.DATA.STD)
        frames = data_utils.spatial_sampling(
            frames, spatial_idx=spatial_idx, min_scale=min_scale,
            max_scale=max_scale, crop_size=crop_size,
            random_horizontal_flip=cfg.DATA.RANDOM_FLIP,
            inverse_uniform_sampling=cfg.DATA.INV_UNIFORM_SAMPLE, rng=rng,
        )
        label = np.int32(seq[-1].get("Phase_gt", -1))
        pathways = data_utils.pack_pathway_output(cfg, frames)
        videos = pathways[0] if len(pathways) == 1 else tuple(pathways)
        return videos, label, np.int32(index), {}
