"""The training side of the port's data layer against the JAX package's on
the same inputs: RandAugment with boxes, the SSv2 and EPIC-Kitchens
datasets in train and val mode (``AUG.ENABLE`` set) on on-disk trees, and
``shuffle_dataset``. Host numpy and PIL in both packages, so the
tolerance is bit-equality (same values, same dtypes).

The datasets' train mode draws from an unseeded ``RandomState(None)``, as
the JAX package's does; these tests alone seed it (in both packages at
once), and seed numpy's global generator, from which RandAugment draws the
sign of its enhancement ops, before each item."""

import numpy as np
import pytest

from focus_tpu_torch.config import get_cfg
from focus_tpu_torch.datasets import loader
from focus_tpu_torch.datasets import rand_augment as ra
from synthetic_data import make_ssv2_tree
from test_torch_port_datasets import assert_same, ek_cfg
from torch_port_trees import jax_cfg_like, write_ssv2_bbox_jsons

AA_TYPE = "rand-m7-n4-mstd0.5-inc1"  # both supervised yamls'


class _Recording(np.random.RandomState):
    """A RandomState that records the ops RandAugment draws."""

    def __init__(self, seed):
        super().__init__(seed)
        self.drawn = []

    def choice(self, *args, **kwargs):
        out = super().choice(*args, **kwargs)
        self.drawn.extend(str(x) for x in out)
        return out


class _SeededRandomState(np.random.RandomState):
    def __init__(self, seed=None):
        super().__init__(99 if seed is None else seed)


@pytest.mark.parametrize("interpolation", ["bicubic", "bilinear", "random",
                                           "nearest"])
def test_rand_augment_matches_jax(interpolation):
    """``rand_augment_video`` on 32 uint8 frames with xyxy boxes, a new op
    draw each frame (DIFFERENT_AUG_PER_FRAME) and every one of the 15 ops
    drawn: frames and boxes bit-equal to JAX's from one seed; and with one
    draw for the whole clip and no boxes."""
    from focus_tpu.datasets import rand_augment as jra

    rs = np.random.RandomState(5)
    frames = rs.randint(0, 256, (32, 24, 28, 3)).astype(np.uint8)
    xy = rs.rand(32, 3, 2) * 14
    boxes = np.concatenate([xy, xy + 9], axis=-1).astype(np.float32)
    out = {}
    for name, module in (("port", ra), ("jax", jra)):
        rng = _Recording(11)
        np.random.seed(3)
        out[name] = module.rand_augment_video(
            frames, boxes, AA_TYPE, different_per_frame=True, rng=rng,
            interpolation=interpolation) + (rng.drawn,)
        np.random.seed(4)
        out[name] += module.rand_augment_video(
            frames, None, AA_TYPE, rng=np.random.RandomState(12),
            interpolation=interpolation)
    assert_same(out["port"], out["jax"])
    assert sorted(set(out["port"][2])) == sorted(ra._RAND_TRANSFORMS)
    assert out["port"][0].dtype == np.uint8 and out["port"][4] is None
    assert not np.array_equal(out["port"][0], frames)


def test_parse_aa_config_matches_jax():
    from focus_tpu.datasets import rand_augment as jra

    for s in (AA_TYPE, "rand-m9-mstd0.5-inc1", "rand-n2", "rand-m5-inc0"):
        assert ra.parse_aa_config(s) == jra.parse_aa_config(s)


def _seeded(monkeypatch):
    """Both packages' datasets on their PIL path, train mode seeded."""
    import focus_tpu.native

    monkeypatch.setattr(focus_tpu.native, "available", lambda: False)
    monkeypatch.setattr(np.random, "RandomState", _SeededRandomState)


def _items(ds):
    out = []
    for i in range(len(ds)):
        np.random.seed(i)
        out.append(ds[i])
    return out


@pytest.mark.parametrize("mode,boxes", [
    ("train", "detectron2"), ("train", "annotated"), ("val", "detectron2"),
    ("train", "none"),
])
def test_ssv2_train_and_val_match_jax(tmp_path, monkeypatch, mode, boxes):
    """``make_ssv2_tree`` (3 videos of 12 frames, 48 px) with AUG.ENABLE and
    the yamls' RandAugment (a new draw each frame, bicubic): the train
    mode's segment sampling, RandAugment with its boxes, scale jitter,
    random crop and flip, and the val mode, bit-equal to JAX's."""
    from focus_tpu.datasets.ssv2 import Ssv2 as JaxSsv2
    from focus_tpu_torch.datasets.ssv2 import Ssv2

    _seeded(monkeypatch)
    root = str(tmp_path)
    make_ssv2_tree(root, num_videos=3, num_frames=12, size=48)
    write_ssv2_bbox_jsons(root)
    cfg = get_cfg()
    cfg.MODEL.ARCH = "slow"
    cfg.SSV2.DATA_ROOT = cfg.SSV2.SPLITS_ROOT = root
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_JITTER_SCALES = [40, 56]
    cfg.DATA.TRAIN_CROP_SIZE = 36
    cfg.DATA.RANDOM_FLIP = True
    cfg.AUG.ENABLE = True
    cfg.AUG.AA_TYPE = AA_TYPE
    cfg.AUG.DIFFERENT_AUG_PER_FRAME = True
    cfg.ORVIT.ENABLE = boxes != "none"
    cfg.ORVIT.O = 4
    cfg.SSV2.BOXES_FORMAT = "detectron2" if boxes == "none" else boxes
    port = Ssv2(cfg, mode)
    assert port.aug == (mode == "train")
    got = _items(port)
    want = _items(JaxSsv2(jax_cfg_like(cfg), mode))
    assert len(got) == 3
    assert_same(got, want)
    video, _, _, meta = got[0]
    assert video.shape == (4, 36, 36, 3) and video.dtype == np.uint8
    assert ("orvit_bboxes" in meta) == (boxes != "none")
    if boxes != "none":
        assert meta["orvit_bboxes"].shape == (4, 4, 4)


@pytest.mark.parametrize("mode", ["train", "val"])
def test_epickitchens_train_and_val_match_jax(tmp_path, monkeypatch, mode):
    """The EPIC-Kitchens tree (two records at 60 and 50 fps) in train mode
    (a random clip window, scale jitter, random crop and flip with the
    linked boxes) and val mode, with AUG.ENABLE set, which neither
    package's EPIC-Kitchens applies: bit-equal to JAX's, 16 boxes a clip."""
    from focus_tpu.datasets.epickitchens import Epickitchens as JaxEK
    from focus_tpu_torch.datasets.epickitchens import Epickitchens

    _seeded(monkeypatch)
    cfg = ek_cfg(str(tmp_path), frames=16)
    cfg.EPICKITCHENS.TRAIN_LIST = cfg.EPICKITCHENS.VAL_LIST
    cfg.DATA.RANDOM_FLIP = True
    cfg.AUG.ENABLE = True
    got = _items(Epickitchens(cfg, mode))
    want = _items(JaxEK(jax_cfg_like(cfg), mode))
    assert len(got) == 2
    assert_same(got, want)
    video, labels, _, meta = got[1]
    assert video.shape == (16, 36, 36, 3) and video.dtype == np.uint8
    assert labels == {"verb": 41, "noun": 250}
    assert meta["orvit_bboxes"].shape == (16, 4, 4)


def test_shuffle_dataset_matches_jax():
    """``shuffle_dataset`` reseeds the train order by epoch, as JAX's."""
    import focus_tpu.datasets.loader as jax_loader

    class Items:
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return np.full(2, i, np.int32)

    ours = loader.DataLoader(Items(), 3, shuffle=True, drop_last=True,
                             num_workers=2, seed=5, device="cpu")
    theirs = jax_loader.DataLoader(Items(), 3, shuffle=True, drop_last=True,
                                   num_workers=2, seed=5)
    orders = []
    for epoch in (0, 1, 4):
        loader.shuffle_dataset(ours, epoch)
        jax_loader.shuffle_dataset(theirs, epoch)
        got = [b.numpy()[:, 0].tolist() for b in ours]
        assert got == [np.asarray(b)[:, 0].tolist() for b in theirs]
        orders.append(got)
    assert orders[0] != orders[1]
