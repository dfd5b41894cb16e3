"""Temporal sampling (counterpart of ``focus_tpu/datasets/decoder.py``):
``get_start_end_idx`` places the clip (random for train, uniform for the
multi-view test) and ``temporal_sampling`` linspace-samples it. The video
file decode comes with the Kinetics dataset."""

from __future__ import annotations

import math

import numpy as np


def temporal_sampling(frames: np.ndarray, start_idx, end_idx, num_samples):
    """linspace index-select."""
    index = np.linspace(start_idx, end_idx, num_samples)
    index = np.clip(index, 0, frames.shape[0] - 1).astype(np.int64)
    return frames[index]


def get_start_end_idx(video_size, clip_size, clip_idx, num_clips, rng=None,
                      use_offset=False):
    """The clip's first and last frame. ``clip_idx`` -1 draws the start
    from ``rng``; otherwise the ``num_clips`` views are spaced uniformly, or
    with ``use_offset`` (DATA.USE_OFFSET_SAMPLING) the single test clip is
    centred and several are spaced inclusively across the span."""
    delta = max(video_size - clip_size, 0)
    if clip_idx == -1:
        rng = rng or np.random.RandomState()
        start_idx = rng.uniform(0, delta)
    elif use_offset:
        if num_clips == 1:
            start_idx = math.floor(delta / 2)
        else:
            start_idx = clip_idx * math.floor(delta / (num_clips - 1))
    else:
        start_idx = delta * clip_idx / num_clips
    end_idx = start_idx + clip_size - 1
    return start_idx, end_idx
