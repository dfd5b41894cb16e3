"""Dataset utilities (a copy of ``focus_tpu/datasets/utils.py``).

Host-side numpy; everything here runs in loader worker threads. PIL is
imported where an image is read.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from focus_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


def retry_load_images(image_paths: List[str], retry: int = 10) -> List[np.ndarray]:
    """The frames at ``image_paths`` as RGB uint8 arrays, each read again
    up to ``retry`` times."""
    from PIL import Image

    for i in range(retry):
        imgs = []
        try:
            for path in image_paths:
                with Image.open(path) as im:
                    imgs.append(np.asarray(im.convert("RGB")))
            return imgs
        except Exception:  # noqa: BLE001
            logger.warning(f"Reading failed. Will retry. {image_paths[:1]}")
            time.sleep(1.0)
    raise RuntimeError(f"Failed to load images {image_paths}")


def get_sequence(center_idx, half_len, sample_rate, num_frames):
    """Frame indices around a keyframe, clipped (reference utils.py:52-72)."""
    seq = list(range(center_idx - half_len, center_idx + half_len, sample_rate))
    for i, s in enumerate(seq):
        seq[i] = min(max(s, 0), num_frames - 1)
    return seq


def get_random_sampling_rate(long_cycle_sampling_rate, sampling_rate, rng):
    """Multigrid long cycles with fewer frames randomly stretch the
    sampling rate so some clips keep the original span (reference
    utils.py:338-347)."""
    if long_cycle_sampling_rate > 0:
        assert long_cycle_sampling_rate >= sampling_rate
        return int(rng.randint(sampling_rate, long_cycle_sampling_rate + 1))
    return sampling_rate


def multigrid_train_crop(cfg, phase, min_scale: int, crop_size: int):
    """(min_scale, crop_size) of a train or val clip under multigrid
    (reference ssv2.py / kinetics.py:245-262): short-cycle phases 0 and 1
    crop SHORT_CYCLE_FACTORS[phase] x MULTIGRID.DEFAULT_S, and once
    DEFAULT_S is set the lower jitter scale shrinks with the crop."""
    if phase in (0, 1):
        crop_size = int(round(cfg.MULTIGRID.SHORT_CYCLE_FACTORS[phase]
                              * cfg.MULTIGRID.DEFAULT_S))
    if cfg.MULTIGRID.DEFAULT_S > 0:
        min_scale = int(round(float(min_scale) * crop_size
                              / cfg.MULTIGRID.DEFAULT_S))
    return min_scale, crop_size


def split_short_cycle_index(index):
    """(sample index, short-cycle phase or None) of a loader index: the
    short cycle hands the dataset (index, phase)."""
    if isinstance(index, tuple):
        return index
    return index, None


def pack_pathway_output(cfg, frames: np.ndarray) -> List[np.ndarray]:
    """Slow/fast pathway split (reference utils.py:75-108).

    frames: [T, H, W, C] -> list of pathway tensors."""
    if cfg.DATA.REVERSE_INPUT_CHANNEL:
        frames = frames[..., ::-1].copy()
    if cfg.MODEL.ARCH in cfg.MODEL.SINGLE_PATHWAY_ARCH:
        return [frames]
    if cfg.MODEL.ARCH in cfg.MODEL.MULTI_PATHWAY_ARCH:
        fast = frames
        slow_idx = np.linspace(
            0, frames.shape[0] - 1, frames.shape[0] // cfg.SLOWFAST.ALPHA
        ).astype(np.int64)
        slow = frames[slow_idx]
        return [slow, fast]
    raise NotImplementedError(
        f"Model arch {cfg.MODEL.ARCH} is not in "
        f"{cfg.MODEL.SINGLE_PATHWAY_ARCH + cfg.MODEL.MULTI_PATHWAY_ARCH}"
    )


def tensor_normalize(frames: np.ndarray, mean, std) -> np.ndarray:
    """uint8 [0,255] or float [0,1] -> normalized float32
    (reference utils.py:319-337)."""
    frames = np.asarray(frames, np.float32)
    if frames.max() > 1.5:
        frames = frames / 255.0
    return (frames - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def maybe_normalize(frames: np.ndarray, cfg) -> np.ndarray:
    """Host-side normalize, skipped under ``TPU.DEVICE_PREPROCESS``.

    The north-star data path (ops/preprocess.py): uint8 frames stay
    uint8 through the dtype-preserving geometric transforms (crops and
    flips are byte slices; resizes round to the nearest byte — the
    labeled half-ULP deviation documented at TPU.DEVICE_PREPROCESS) and
    the jitted step normalizes on device, cutting host CPU and H2D 4x.
    Float frames (or DEVICE_PREPROCESS off) take the reference's
    host-normalize path (reference datasets/utils.py:319-337)."""
    if cfg.TPU.DEVICE_PREPROCESS and frames.dtype == np.uint8:
        return frames
    return tensor_normalize(frames, cfg.DATA.MEAN, cfg.DATA.STD)


def revert_tensor_normalize(frames: np.ndarray, mean, std) -> np.ndarray:
    """Undo ``tensor_normalize`` back to [0, 1] floats (reference
    utils.py revert_tensor_normalize)."""
    frames = np.asarray(frames, np.float32)
    return frames * np.asarray(std, np.float32) + np.asarray(
        mean, np.float32
    )


def spatial_sampling(
    frames: np.ndarray,
    spatial_idx: int = -1,
    min_scale: int = 256,
    max_scale: int = 320,
    crop_size: int = 224,
    random_horizontal_flip: bool = True,
    inverse_uniform_sampling: bool = False,
    aspect_ratio=None,
    scale=None,
    motion_shift: bool = False,
    rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """Scale-jitter + crop (+flip) (reference utils.py:111-187).

    frames: [T, H, W, C]. spatial_idx -1 => random crop (train);
    0/1/2 => left/center/right (or top/center/bottom) crop (test).
    When ``scale``/``aspect_ratio`` are given (the MViT recipes'
    TRAIN_JITTER_SCALES_RELATIVE / _ASPECT_RELATIVE), training uses
    Inception-style relative crops; ``motion_shift`` pans the crop box
    across the clip (reference utils.py:152-176)."""
    rng = rng or np.random.RandomState()
    from focus_tpu_torch.datasets import transform as xf

    if spatial_idx == -1:
        if aspect_ratio is None and scale is None:
            frames = xf.random_short_side_scale_jitter(
                frames, min_scale, max_scale, rng,
                inverse_uniform_sampling=inverse_uniform_sampling,
            )
            frames = xf.random_crop(frames, crop_size, rng)
        else:
            crop_fn = (
                xf.random_resized_crop_with_shift
                if motion_shift
                else xf.random_resized_crop
            )
            frames = crop_fn(
                frames, crop_size, crop_size, rng,
                scale=tuple(scale), ratio=tuple(aspect_ratio),
            )
        if random_horizontal_flip:
            frames = xf.horizontal_flip(frames, 0.5, rng)
    else:
        assert spatial_idx in (0, 1, 2)
        frames = xf.random_short_side_scale_jitter(
            frames, min_scale, min_scale, rng
        )
        frames = xf.uniform_crop(frames, crop_size, spatial_idx)
    return frames
