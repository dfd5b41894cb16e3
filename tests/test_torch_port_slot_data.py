"""The port's MOVi-E datasets and their loader batches on the CPU against
the JAX package's, on PNG episodes written to a temporary tree laid out as
the MOVi-E export is (``frames/<episode>/NNNNNNNN_image.png`` and
``masks/<episode>/NNNNNNNN_mask_SS.png``): bit-equal clips, masks and
batches."""

import numpy as np
import pytest
import torch

from focus_tpu.config import get_cfg as jax_get_cfg
from focus_tpu.datasets import loader as jloader
from focus_tpu.datasets import movi_e as jmovi
from focus_tpu_torch.config import get_cfg
from focus_tpu_torch.datasets import loader as tloader
from focus_tpu_torch.datasets import movi_e as tmovi
from focus_tpu_torch.datasets.build import build_dataset

EPISODES, FRAMES, SIDE, SEGS = 8, 5, 40, 4


@pytest.fixture(scope="module")
def movi_tree(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("movi_e")
    rs = np.random.RandomState(0)
    for e in range(EPISODES):
        fdir, mdir = root / "frames" / f"ep{e:03d}", root / "masks" / f"ep{e:03d}"
        fdir.mkdir(parents=True)
        mdir.mkdir(parents=True)
        for n in range(FRAMES):
            rgb = rs.randint(0, 256, (SIDE, SIDE, 3), dtype=np.uint8)
            Image.fromarray(rgb).save(fdir / f"{n:08d}_image.png")
            seg = rs.randint(0, SEGS, (SIDE, SIDE))
            for s in range(SEGS):
                Image.fromarray(((seg == s) * 255).astype(np.uint8)).save(
                    mdir / f"{n:08d}_mask_{s:02d}.png")
        (fdir / "notes.txt").write_text("not a frame")  # outside GLOB_EXP
    return root


def configure(cfg, root):
    cfg.DATA.PATH_TO_DATA_DIR = str(root / "frames" / "*")
    cfg.DATA.GLOB_EXP = "????????_image.png"  # configs/movi_e/base.yaml's
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.DATA.NUM_SEGS = SEGS
    cfg.SLOTS.NUM_ITERS = 2
    cfg.TRAIN.DATASET = "movi_e"
    cfg.TEST.DATASET = "movi_e_with_masks"
    cfg.TRAIN.BATCH_SIZE = 3
    cfg.TEST.BATCH_SIZE = 5
    cfg.DATA_LOADER.NUM_WORKERS = 2
    return cfg


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_movi_e_clips_bit_equal(movi_tree, mode):
    """The split's episodes (70 / 15 / 15% of the sorted directories, clips
    of NUM_ITERS frames, the tail dropped) and every clip, float32
    [T, H, W, C] in [0, 1]."""
    ref = jmovi.Movi_e(configure(jax_get_cfg(), movi_tree), mode)
    got = tmovi.Movi_e(configure(get_cfg(), movi_tree), mode)
    assert got.episodes == ref.episodes and len(got) > 0
    for i in range(len(got)):
        clip = got[i]
        assert clip.shape == (2, 32, 32, 3) and clip.dtype == np.float32
        assert same(clip, ref[i]), i


def test_movi_e_with_masks_bit_equal(movi_tree):
    """Every directory's clips with their [T, NUM_SEGS, H, W, 1] binary
    masks, from the ``masks`` tree."""
    ref = jmovi.Movi_e_with_masks(configure(jax_get_cfg(), movi_tree), "test")
    got = tmovi.Movi_e_with_masks(configure(get_cfg(), movi_tree), "test")
    assert got.episodes_mask == ref.episodes_mask
    assert len(got) == EPISODES * (FRAMES // 2)
    for i in range(len(got)):
        (video, masks), (rv, rm) = got[i], ref[i]
        assert masks.shape == (2, SEGS, 32, 32, 1)
        assert set(np.unique(masks)) <= {0.0, 1.0}
        assert same(video, rv) and same(masks, rm), i


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_loader_batches_bit_equal(movi_tree, split):
    """The loaders' batches: a video-only batch for train (shuffled, the
    epoch's seed) and val, (video, masks) for test, the last eval batch
    padded by repeating its leading clips; ``real_rows`` counts the clips
    that are not repeats."""
    ref = jloader.construct_loader(configure(jax_get_cfg(), movi_tree), split)
    got = tloader.construct_loader(configure(get_cfg(), movi_tree), split,
                                   device="cpu")
    for loader in (ref, got):
        loader.set_epoch(1)
    rb, gb = list(ref), list(got)
    assert len(gb) == len(rb) == len(got)
    real = 0
    for i, (g, r) in enumerate(zip(gb, rb)):
        if split == "test":
            assert isinstance(g, tuple) and len(g) == 2
            assert same(g[0].numpy(), r[0]) and same(g[1].numpy(), r[1]), i
        else:
            assert torch.is_tensor(g) and same(g.numpy(), r), i
        real += got.real_rows(i)
    assert real == (len(got.dataset) if split != "train"
                    else len(gb) * got.batch_size)


def test_dataset_registry(movi_tree):
    """Both datasets are registered; Cholec80 raises, naming itself."""
    cfg = configure(get_cfg(), movi_tree)
    assert isinstance(build_dataset("movi_e", cfg, "val"), tmovi.Movi_e)
    assert isinstance(build_dataset("movi_e_with_masks", cfg, "test"),
                      tmovi.Movi_e_with_masks)
    with pytest.raises(NotImplementedError, match="Cholec80"):
        build_dataset("cholec80", cfg, "train")
