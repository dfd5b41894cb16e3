"""Kinetics video dataset (counterpart of ``focus_tpu/datasets/kinetics.py``).

CSV rows of ``path label``; each file is read by ``decoder.decode`` (looked
up on the module at every read), retried on failure and replaced by a
random video after the third failure. Train and val take one random clip;
test enumerates NUM_ENSEMBLE_VIEWS temporal x NUM_SPATIAL_CROPS spatial
views. With ``AUG.ENABLE`` the train mode takes the MViT recipe per view:
RandAugment, the normalisation (skipped for uint8 under
``TPU.DEVICE_PREPROCESS``), the relative scale / aspect crop (motion-shifted
with ``DATA.TRAIN_JITTER_MOTION_SHIFT``) and random erasing; ``AUG.NUM_SAMPLE``
views come back stacked on a leading axis with their labels and indices,
and the loader flattens them into the batch. The train mode's generator is
unseeded, as the JAX package's.
"""

from __future__ import annotations

import os

import numpy as np

from focus_tpu_torch.datasets import decoder
from focus_tpu_torch.datasets import utils as data_utils
from focus_tpu_torch.datasets.build import DATASET_REGISTRY
from focus_tpu_torch.datasets.rand_augment import rand_augment_video
from focus_tpu_torch.datasets.random_erasing import RandomErasing
from focus_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


@DATASET_REGISTRY.register()
class Kinetics:
    # a train item holds AUG.NUM_SAMPLE views on a leading axis, which the
    # loader flattens into the batch
    STACKS_VIEWS = True

    def __init__(self, cfg, mode, num_retries=10):
        assert mode in ["train", "val", "test"]
        self.cfg = cfg
        self.mode = mode
        self._num_retries = num_retries
        self._num_clips = (
            1 if mode in ["train", "val"]
            else cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        )
        self.aug = mode == "train" and cfg.AUG.ENABLE
        self.rand_erase = self.aug and cfg.AUG.RE_PROB > 0
        self._construct_loader()

    def _construct_loader(self):
        path_to_file = os.path.join(
            self.cfg.DATA.PATH_TO_DATA_DIR, f"{self.mode}.csv"
        )
        assert os.path.exists(path_to_file), f"{path_to_file} not found"
        self._path_to_videos, self._labels, self._spatial_temporal_idx = [], [], []
        with open(path_to_file) as f:
            for line in f.read().splitlines():
                path, label = line.split(self.cfg.DATA.PATH_LABEL_SEPARATOR)
                for idx in range(self._num_clips):
                    self._path_to_videos.append(
                        os.path.join(self.cfg.DATA.PATH_PREFIX, path)
                    )
                    self._labels.append(int(label))
                    self._spatial_temporal_idx.append(idx)
        logger.info(
            f"Kinetics {self.mode}: {len(self._path_to_videos)} clips "
            f"from {path_to_file}"
        )

    def __len__(self):
        return len(self._path_to_videos)

    def __getitem__(self, index):
        cfg = self.cfg
        rng = np.random.RandomState(None if self.mode == "train" else index)
        if self.mode in ["train", "val"]:
            temporal_idx = -1
            spatial_idx = -1
            min_scale, max_scale = cfg.DATA.TRAIN_JITTER_SCALES
            crop_size = cfg.DATA.TRAIN_CROP_SIZE
        else:
            temporal_idx = (
                self._spatial_temporal_idx[index] // cfg.TEST.NUM_SPATIAL_CROPS
            )
            spatial_idx = (
                self._spatial_temporal_idx[index] % cfg.TEST.NUM_SPATIAL_CROPS
            )
            # a 256 test crop is taken from the 256 short side; any other
            # from the train jitter's lower scale
            min_scale, max_scale, crop_size = (
                [cfg.DATA.TEST_CROP_SIZE] * 3
                if cfg.DATA.TEST_CROP_SIZE == 256
                else [cfg.DATA.TRAIN_JITTER_SCALES[0]] * 2
                + [cfg.DATA.TEST_CROP_SIZE]
            )

        frames = None
        for r in range(self._num_retries):
            frames = decoder.decode(
                self._path_to_videos[index],
                data_utils.get_random_sampling_rate(
                    cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE,
                    cfg.DATA.SAMPLING_RATE,
                    rng,
                ),
                cfg.DATA.NUM_FRAMES,
                clip_idx=temporal_idx,
                num_clips=cfg.TEST.NUM_ENSEMBLE_VIEWS,
                target_fps=cfg.DATA.TARGET_FPS,
                rng=rng,
                use_offset=bool(cfg.DATA.USE_OFFSET_SAMPLING),
            )
            if frames is not None:
                break
            logger.warning(
                f"Failed to decode {self._path_to_videos[index]}, retry {r}"
            )
            if r >= 2:
                index = rng.randint(len(self))
        if frames is None:
            raise RuntimeError("Failed to fetch video after retries")

        label = np.int32(self._labels[index])
        if self.aug:
            samples = []
            for _ in range(max(cfg.AUG.NUM_SAMPLE, 1)):
                f = self._aug_frame(
                    frames, spatial_idx, min_scale, max_scale, crop_size, rng
                )
                pathways = data_utils.pack_pathway_output(cfg, f)
                samples.append(
                    pathways[0] if len(pathways) == 1 else tuple(pathways)
                )
            if cfg.AUG.NUM_SAMPLE > 1:
                videos = (
                    np.stack(samples)
                    if not isinstance(samples[0], tuple)
                    else tuple(
                        np.stack([s[i] for s in samples])
                        for i in range(len(samples[0]))
                    )
                )
                n = cfg.AUG.NUM_SAMPLE
                return (
                    videos,
                    np.full((n,), label, np.int32),
                    np.full((n,), index, np.int32),
                    {},
                )
            return samples[0], label, np.int32(index), {}

        frames = data_utils.maybe_normalize(frames, cfg)
        frames = data_utils.spatial_sampling(
            frames,
            spatial_idx=spatial_idx,
            min_scale=min_scale,
            max_scale=max_scale,
            crop_size=crop_size,
            random_horizontal_flip=cfg.DATA.RANDOM_FLIP,
            inverse_uniform_sampling=cfg.DATA.INV_UNIFORM_SAMPLE,
            rng=rng,
        )
        pathways = data_utils.pack_pathway_output(cfg, frames)
        videos = pathways[0] if len(pathways) == 1 else tuple(pathways)
        return videos, label, np.int32(index), {}

    def _aug_frame(self, frames, spatial_idx, min_scale, max_scale,
                   crop_size, rng):
        """One augmented view: RandAugment on the uint8 frames
        (``AUG.AA_TYPE``; PIL), the normalisation, the relative scale /
        aspect crop, random erasing."""
        cfg = self.cfg
        if cfg.AUG.AA_TYPE:
            f, _ = rand_augment_video(
                frames, None, cfg.AUG.AA_TYPE, rng=rng,
                interpolation=cfg.AUG.INTERPOLATION,
            )
        else:
            f = frames
        f = data_utils.maybe_normalize(f, cfg)
        scl = list(cfg.DATA.TRAIN_JITTER_SCALES_RELATIVE)
        asp = list(cfg.DATA.TRAIN_JITTER_ASPECT_RELATIVE)
        f = data_utils.spatial_sampling(
            f,
            spatial_idx=spatial_idx,
            min_scale=min_scale,
            max_scale=max_scale,
            crop_size=crop_size,
            random_horizontal_flip=cfg.DATA.RANDOM_FLIP,
            inverse_uniform_sampling=cfg.DATA.INV_UNIFORM_SAMPLE,
            aspect_ratio=asp if asp else None,
            scale=scl if scl else None,
            motion_shift=cfg.DATA.TRAIN_JITTER_MOTION_SHIFT,
            rng=rng,
        )
        if self.rand_erase:
            erase = RandomErasing(
                cfg.AUG.RE_PROB, mode=cfg.AUG.RE_MODE,
                max_count=cfg.AUG.RE_COUNT, num_splits=cfg.AUG.RE_COUNT,
                mean=cfg.DATA.MEAN, std=cfg.DATA.STD,
            )
            f = erase(f, rng=rng)
        return f
