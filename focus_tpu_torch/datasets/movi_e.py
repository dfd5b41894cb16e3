"""MOVi-E episode datasets (counterpart of ``focus_tpu/datasets/movi_e.py``;
reference ``slowfast/datasets/movi_e.py``).

Episodes are directories of PNG frames cut into clips of
``SLOTS.NUM_ITERS`` frames (the reference's episode length, movi_e.py:32).
A clip is float32 ``[T, H, W, C]`` in [0, 1]; the masks variant adds
binary masks ``[T, NUM_SEGS, H, W, 1]``. PIL is imported where a file is
read: the card's machine has none.
"""

import glob
import os
from pathlib import Path

import numpy as np

from focus_tpu_torch.datasets.build import DATASET_REGISTRY


def _open(path):
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    return Image.open(path)


def _load_frame(path, size):
    img = _open(path).convert("RGB").resize((size, size))
    return np.asarray(img, np.float32) / 255.0  # HWC in [0, 1]


def _load_mask(path, size):
    img = _open(path).convert("1").resize((size, size))
    return np.asarray(img, np.float32)[..., None]  # [H, W, 1]


@DATASET_REGISTRY.register()
class Movi_e:
    """The first 70% of the sorted episode directories train, the next 15%
    validate, the last 15% test; each directory's frames in clips of
    NUM_ITERS, a shorter tail dropped."""

    def __init__(self, cfg, mode="train"):
        self.img_size = cfg.DATA.TRAIN_CROP_SIZE
        self.ep_len = cfg.SLOTS.NUM_ITERS
        total_dirs = sorted(glob.glob(cfg.DATA.PATH_TO_DATA_DIR))
        n = len(total_dirs)
        if mode == "train":
            total_dirs = total_dirs[: int(n * 0.7)]
        elif mode == "val":
            total_dirs = total_dirs[int(n * 0.7): int(n * 0.85)]
        elif mode == "test":
            total_dirs = total_dirs[int(n * 0.85):]
        self.episodes = []
        for d in total_dirs:
            paths = sorted(glob.glob(os.path.join(d, cfg.DATA.GLOB_EXP)))
            for i in range(0, len(paths) - self.ep_len + 1, self.ep_len):
                self.episodes.append(paths[i: i + self.ep_len])

    def __len__(self):
        return len(self.episodes)

    def __getitem__(self, idx):
        return np.stack([_load_frame(p, self.img_size)
                         for p in self.episodes[idx]])  # [T, H, W, C]


@DATASET_REGISTRY.register()
class Movi_e_with_masks:
    """Every episode directory, whatever the split (reference
    movi_e.py:72-137); frame ``NNNNNNNN_image.png``'s masks are
    ``NNNNNNNN_mask_SS.png`` in the directory named with ``frames``
    replaced by ``masks``."""

    def __init__(self, cfg, mode="train"):
        self.img_size = cfg.DATA.TRAIN_CROP_SIZE
        self.ep_len = cfg.SLOTS.NUM_ITERS
        self.num_segs = cfg.DATA.NUM_SEGS
        self.episodes_rgb, self.episodes_mask = [], []
        for d in sorted(glob.glob(cfg.DATA.PATH_TO_DATA_DIR)):
            paths = sorted(glob.glob(os.path.join(d, cfg.DATA.GLOB_EXP)))
            buf_rgb, buf_mask = [], []
            for image_path in paths:
                p = Path(image_path)
                buf_rgb.append(image_path)
                parent = str(p.parent).replace("frames", "masks")
                stem = p.stem.split("_")[0]
                buf_mask.append([
                    os.path.join(parent, f"{stem}_mask_{n:02}.png")
                    for n in range(self.num_segs)])
                if len(buf_rgb) == self.ep_len:
                    self.episodes_rgb.append(buf_rgb)
                    self.episodes_mask.append(buf_mask)
                    buf_rgb, buf_mask = [], []

    def __len__(self):
        return len(self.episodes_rgb)

    def __getitem__(self, idx):
        video = np.stack([_load_frame(p, self.img_size)
                          for p in self.episodes_rgb[idx]])
        masks = np.stack([
            np.stack([_load_mask(mp, self.img_size) for mp in frame_masks])
            for frame_masks in self.episodes_mask[idx]])
        return video, masks  # [T, H, W, C], [T, S, H, W, 1]
