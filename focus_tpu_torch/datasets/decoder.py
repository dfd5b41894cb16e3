"""Video decoding (counterpart of ``focus_tpu/datasets/decoder.py``):
``get_start_end_idx`` places the clip (random for train, uniform for the
multi-view test) and ``temporal_sampling`` linspace-samples it; ``decode``
reads a file through OpenCV's FFmpeg bindings (the reference's PyAV is not
used), seeking to the clip's window where the container tells its frame
count, else decoding the whole file. cv2 is imported where a file is read.
"""

from __future__ import annotations

import math

import numpy as np

from focus_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


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


def decode_video_cv2(path: str, max_frames: int = 100000):
    """Every frame of a video file as [T, H, W, C] uint8 RGB, and its fps;
    (None, fps) where nothing decodes."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        return None, 30.0
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    frames = []
    while len(frames) < max_frames:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[:, :, ::-1])  # BGR -> RGB
    cap.release()
    if not frames:
        return None, fps
    return np.stack(frames), fps


def probe_video_cv2(path: str):
    """The container's (frame count, fps) without decoding, or None."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        return None
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    cap.release()
    if total <= 0 or fps <= 0:
        return None
    return total, fps


def decode_window_cv2(path: str, start: int, end: int):
    """Frames [start, end] (inclusive) as uint8 RGB: one seek to ``start``
    (to the nearest keyframe, rolled forward), then a sequential read.
    None where the seek lands elsewhere or nothing is read."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        return None
    if start > 0:
        cap.set(cv2.CAP_PROP_POS_FRAMES, start)
        if int(cap.get(cv2.CAP_PROP_POS_FRAMES)) != start:
            cap.release()
            return None
    frames = []
    for _ in range(end - start + 1):
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[:, :, ::-1])  # BGR -> RGB
    cap.release()
    if not frames:
        return None
    return np.stack(frames)


def decode(
    path: str,
    sampling_rate: int,
    num_frames: int,
    clip_idx: int = -1,
    num_clips: int = 10,
    target_fps: int = 30,
    rng=None,
    selective: bool = True,
    use_offset: bool = False,
):
    """The clip of ``num_frames`` frames, ``sampling_rate`` apart at
    ``target_fps``, as [num_frames, H, W, C] uint8, or None on failure.
    With ``selective`` only the clip's window is decoded, placed from the
    container's frame count; without that count, or where the seek fails,
    the whole file is decoded and the clip placed in it. A missing cv2
    raises ``ImportError`` (the JAX package's counts it a failed decode,
    which the dataset retries ten times before it raises)."""
    try:
        meta = probe_video_cv2(path) if selective else None
        if meta is not None:
            total, fps = meta
            clip_size = sampling_rate * num_frames / target_fps * fps
            start_idx, end_idx = get_start_end_idx(
                total, clip_size, clip_idx, num_clips, rng,
                use_offset=use_offset,
            )
            s = max(int(np.floor(start_idx)), 0)
            e = min(int(np.ceil(end_idx)), total - 1)
            frames = decode_window_cv2(path, s, e)
            if frames is not None:
                return temporal_sampling(
                    frames, start_idx - s, end_idx - s, num_frames
                )
        frames, fps = decode_video_cv2(path)
    except ImportError:
        raise
    except Exception as e:  # noqa: BLE001
        logger.warning(f"Failed to decode {path}: {e}")
        return None
    if frames is None:
        return None
    clip_size = sampling_rate * num_frames / target_fps * fps
    start_idx, end_idx = get_start_end_idx(
        frames.shape[0], clip_size, clip_idx, num_clips, rng,
        use_offset=use_offset,
    )
    return temporal_sampling(frames, start_idx, end_idx, num_frames)
