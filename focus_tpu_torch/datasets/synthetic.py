"""Synthetic datasets for tests (a copy of ``focus_tpu/datasets/synthetic.py``;
replaces on-disk data when none is mounted)."""

import numpy as np

from focus_tpu_torch.datasets.build import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class Synthetic_video:
    """Random clips shaped like MOVi-E episodes: [T, H, W, C] in [0, 1].
    Deterministic per index."""

    def __init__(self, cfg, mode="train"):
        self.size = {"train": 64, "val": 16, "test": 16}[mode]
        self.t = cfg.DATA.NUM_FRAMES
        self.hw = cfg.DATA.TRAIN_CROP_SIZE
        self.c = cfg.SLOTS.IMG_CHANNELS if hasattr(cfg, "SLOTS") else 3

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        rs = np.random.RandomState(idx)
        return rs.rand(self.t, self.hw, self.hw, self.c).astype(np.float32)


@DATASET_REGISTRY.register()
class Synthetic_video_with_masks:
    """Random clips + blocky GT masks, shaped like Movi_e_with_masks."""

    def __init__(self, cfg, mode="test"):
        self.size = 16
        self.t = cfg.DATA.NUM_FRAMES
        self.hw = cfg.DATA.TRAIN_CROP_SIZE
        self.num_segs = cfg.DATA.NUM_SEGS

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        rs = np.random.RandomState(idx)
        video = rs.rand(self.t, self.hw, self.hw, 3).astype(np.float32)
        seg_id = rs.randint(0, self.num_segs, size=(self.t, self.hw, self.hw))
        masks = np.stack(
            [(seg_id == s).astype(np.float32)[..., None] for s in range(self.num_segs)],
            axis=1,
        )  # [T, S, H, W, 1]
        return video, masks


@DATASET_REGISTRY.register()
class Synthetic_classification:
    """Random clips + labels: ([T, H, W, C], label)."""

    def __init__(self, cfg, mode="train"):
        self.size = {"train": 64, "val": 16, "test": 16}[mode]
        self.t = cfg.DATA.NUM_FRAMES
        self.hw = cfg.DATA.TRAIN_CROP_SIZE if mode == "train" else cfg.DATA.TEST_CROP_SIZE
        self.num_classes = cfg.MODEL.NUM_CLASSES

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        rs = np.random.RandomState(idx)
        video = rs.rand(self.t, self.hw, self.hw, 3).astype(np.float32)
        label = np.int32(idx % self.num_classes)
        return video, label, np.int32(idx), {}
