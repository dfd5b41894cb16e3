"""Random erasing (counterpart of ``focus_tpu/datasets/random_erasing.py``,
itself the reference's port of timm's): host numpy on [T, H, W, C] clips.
"""

from __future__ import annotations

import math

import numpy as np


class RandomErasing:
    """Erase ``min_count``..``max_count`` boxes of a clip with probability
    ``probability``; the fill is 0 ('const'), one normal draw per channel
    ('rand') or one per pixel ('pixel'), in normalised units. ``cube``
    erases the box in every frame, else in one drawn frame."""

    def __init__(
        self,
        probability=0.5,
        min_area=0.02,
        max_area=1 / 3,
        min_aspect=0.3,
        max_aspect=None,
        mode="const",
        min_count=1,
        max_count=None,
        num_splits=0,
        cube=True,
        mean=(0.45, 0.45, 0.45),
        std=(0.225, 0.225, 0.225),
    ):
        self.probability = probability
        self.min_area = min_area
        self.max_area = max_area
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))
        self.min_count = min_count
        self.max_count = max_count or min_count
        self.mode = mode
        self.cube = cube
        # uint8 clips (TPU.DEVICE_PREPROCESS) are normalised on the device
        # later, so the fill, defined in normalised units, becomes
        # (z * std + mean) * 255 rounded and clipped to the byte range
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def _get_pixels(self, shape, dtype, rng):
        if self.mode == "pixel":
            noise = rng.randn(*shape)
        elif self.mode == "rand":
            noise = rng.randn(1, 1, shape[-1])
        else:
            noise = None
        if dtype == np.uint8:
            if noise is None:  # 0 in normalised units is the mean pixel
                px = np.broadcast_to(self.mean * 255.0, shape)
            else:
                px = (noise * self.std + self.mean) * 255.0
            return np.clip(np.rint(px), 0, 255).astype(np.uint8)
        if noise is None:
            return np.zeros(shape, dtype)
        return noise.astype(dtype)

    def __call__(self, frames: np.ndarray, rng=None) -> np.ndarray:
        """frames: [T, H, W, C], uint8 or normalised float."""
        rng = rng or np.random.RandomState()
        if rng.rand() > self.probability:
            return frames
        frames = frames.copy()
        T, H, W, C = frames.shape
        area = H * W
        count = rng.randint(self.min_count, self.max_count + 1)
        for _ in range(count):
            for _attempt in range(10):
                target_area = rng.uniform(self.min_area, self.max_area) * area / count
                aspect = math.exp(rng.uniform(*self.log_aspect_ratio))
                h = int(round(math.sqrt(target_area * aspect)))
                w = int(round(math.sqrt(target_area / aspect)))
                if w < W and h < H:
                    top = rng.randint(0, H - h)
                    left = rng.randint(0, W - w)
                    patch = self._get_pixels((h, w, C), frames.dtype, rng)
                    if self.cube:
                        frames[:, top : top + h, left : left + w] = patch
                    else:
                        t = rng.randint(0, T)
                        frames[t, top : top + h, left : left + w] = patch
                    break
        return frames
