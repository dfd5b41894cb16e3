"""The port's data layer against the JAX package's on the same inputs: the
transforms and dataset utilities, ``sort_boxes_sorted``, the SSv2 and
EPIC-Kitchens datasets in test and val mode on on-disk trees, and the
loader's batching. Everything here is host numpy in both packages, so the
tolerance is bit-equality (same values, same dtypes)."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import focus_tpu.datasets.loader as jax_loader
import focus_tpu.datasets.transform as jax_xf
import focus_tpu.datasets.utils as jax_du
from focus_tpu.datasets import decoder as jax_decoder
from focus_tpu.utils.linkboxes.sort import sort_boxes_sorted as jax_sort
from focus_tpu_torch.config import get_cfg
from focus_tpu_torch.datasets import decoder, loader
from focus_tpu_torch.datasets import transform as xf
from focus_tpu_torch.datasets import utils as du
from focus_tpu_torch.utils.box_ops import zero_empty_boxes_np
from focus_tpu_torch.utils.linkboxes.sort import sort_boxes_sorted
from synthetic_data import make_ssv2_tree
from torch_port_trees import jax_cfg_like, make_ek_tree, write_ssv2_bbox_jsons


def assert_same(a, b):
    """Bit-equal trees of arrays, scalars and dicts (same dtypes too)."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_same(a[k], b[k])
    elif torch.is_tensor(a):
        assert_same(a.numpy(), b)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def frames_and_boxes(dtype, tall=False):
    rs = np.random.RandomState(3)
    frames = rs.randint(0, 256, (4, 30, 40, 3)).astype(np.uint8)
    if tall:
        frames = np.ascontiguousarray(frames.transpose(0, 2, 1, 3))
    if dtype == "float32":
        frames = frames.astype(np.float32) / 255.0
    xy = rs.rand(4, 3, 2).astype(np.float32) * 20
    boxes = np.concatenate([xy, xy + 8], axis=-1)
    return frames, boxes


EIGVAL = [0.2175, 0.0188, 0.0045]
EIGVEC = [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
          [-0.5836, -0.6948, 0.4203]]

TRANSFORMS = {
    "scale_jitter": lambda m, f, b, rng: m.random_short_side_scale_jitter(
        f, 32, 48, rng, boxes=b),
    "scale_jitter_inverse": lambda m, f, b, rng:
        m.random_short_side_scale_jitter(f, 24, 48, rng,
                                         inverse_uniform_sampling=True),
    "scale_jitter_same_size": lambda m, f, b, rng:
        m.random_short_side_scale_jitter(f, min(f.shape[1:3]),
                                         min(f.shape[1:3]), rng, boxes=b),
    "random_crop": lambda m, f, b, rng: m.random_crop(f, 24, rng, boxes=b),
    "uniform_crop_0": lambda m, f, b, rng: m.uniform_crop(f, 24, 0, boxes=b),
    "uniform_crop_1": lambda m, f, b, rng: m.uniform_crop(f, 24, 1, boxes=b),
    "uniform_crop_2": lambda m, f, b, rng: m.uniform_crop(f, 24, 2),
    "uniform_crop_scaled": lambda m, f, b, rng: m.uniform_crop(
        f, 24, 2, boxes=b, scale_size=36),
    "horizontal_flip": lambda m, f, b, rng: m.horizontal_flip(
        f, 1.0, rng, boxes=b),
    "horizontal_flip_drawn": lambda m, f, b, rng: [
        m.horizontal_flip(f, 0.5, rng) for _ in range(4)],
    "clip_boxes": lambda m, f, b, rng: m.clip_boxes_to_image(b * 2, 30, 40),
    "random_resized_crop": lambda m, f, b, rng: m.random_resized_crop(
        f, 24, 20, rng, boxes=b),
    "random_resized_crop_fallback": lambda m, f, b, rng:
        m.random_resized_crop(f, 24, 24, rng, scale=(2.0, 3.0),
                              ratio=(2.0, 3.0)),
    "random_resized_crop_with_shift": lambda m, f, b, rng:
        m.random_resized_crop_with_shift(f, 24, 24, rng),
    "blend": lambda m, f, b, rng: m.blend(f, f[::-1], 0.3),
    "grayscale": lambda m, f, b, rng: m.grayscale(f),
    "brightness": lambda m, f, b, rng: m.brightness_jitter(0.4, f, rng),
    "contrast": lambda m, f, b, rng: m.contrast_jitter(0.4, f, rng),
    "saturation": lambda m, f, b, rng: m.saturation_jitter(0.4, f, rng),
    "color_jitter": lambda m, f, b, rng: m.color_jitter(f, rng, 0.4, 0.4,
                                                        0.4),
    "lighting": lambda m, f, b, rng: m.lighting_jitter(f, 0.1, EIGVAL,
                                                       EIGVEC, rng),
    "color_normalization": lambda m, f, b, rng: m.color_normalization(
        f, [0.45, 0.45, 0.45], [0.225, 0.225, 0.225]),
}


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name, dtype):
    for tall in (False, True):
        frames, boxes = frames_and_boxes(dtype, tall)
        got = TRANSFORMS[name](xf, frames.copy(), boxes.copy(),
                               np.random.RandomState(7))
        want = TRANSFORMS[name](jax_xf, frames.copy(), boxes.copy(),
                                np.random.RandomState(7))
        assert_same(got, want)


def _cfg(arch="slow", device_preprocess=True):
    cfg = get_cfg()
    cfg.MODEL.ARCH = arch
    cfg.TPU.DEVICE_PREPROCESS = device_preprocess
    return cfg


UTILS = {
    "tensor_normalize": lambda m, f, rng: m.tensor_normalize(
        f, [0.45, 0.4, 0.5], [0.2, 0.25, 0.3]),
    "maybe_normalize": lambda m, f, rng: m.maybe_normalize(f, _cfg()),
    "maybe_normalize_off": lambda m, f, rng: m.maybe_normalize(
        f, _cfg(device_preprocess=False)),
    "revert_tensor_normalize": lambda m, f, rng: m.revert_tensor_normalize(
        f, [0.45, 0.4, 0.5], [0.2, 0.25, 0.3]),
    "pack_pathway_slow": lambda m, f, rng: m.pack_pathway_output(_cfg(), f),
    "pack_pathway_slowfast": lambda m, f, rng: m.pack_pathway_output(
        _cfg("slowfast"), np.concatenate([f, f])),
    "spatial_sampling_train": lambda m, f, rng: m.spatial_sampling(
        f, -1, 32, 40, 24, rng=rng),
    "spatial_sampling_relative": lambda m, f, rng: m.spatial_sampling(
        f, -1, 32, 40, 24, aspect_ratio=(0.75, 1.33), scale=(0.3, 1.0),
        rng=rng),
    "spatial_sampling_shift": lambda m, f, rng: m.spatial_sampling(
        f, -1, 32, 40, 24, aspect_ratio=(0.75, 1.33), scale=(0.3, 1.0),
        motion_shift=True, rng=rng),
    "spatial_sampling_test": lambda m, f, rng: [
        m.spatial_sampling(f, i, 32, 32, 24, rng=rng) for i in range(3)],
    "get_sequence": lambda m, f, rng: m.get_sequence(5, 8, 2, 12),
    "random_sampling_rate": lambda m, f, rng: [
        m.get_random_sampling_rate(8, 2, rng),
        m.get_random_sampling_rate(0, 2, rng)],
}


@pytest.mark.parametrize("name", sorted(UTILS))
def test_dataset_utils_match_jax(name):
    for dtype in ("uint8", "float32"):
        frames, _ = frames_and_boxes(dtype)
        got = UTILS[name](du, frames.copy(), np.random.RandomState(5))
        want = UTILS[name](jax_du, frames.copy(), np.random.RandomState(5))
        assert_same(got, want)


def test_decoder_sampling_matches_jax():
    frames = np.arange(40 * 2).reshape(40, 2)
    for args in ((100, 32, 3, 10), (20, 32, 1, 3), (100, 32, -1, 1)):
        for use_offset in (False, True):
            for n in (1, 3):
                got = decoder.get_start_end_idx(
                    args[0], args[1], args[2], n, np.random.RandomState(2),
                    use_offset=use_offset)
                want = jax_decoder.get_start_end_idx(
                    args[0], args[1], args[2], n, np.random.RandomState(2),
                    use_offset=use_offset)
                assert got == want
    for start, end, n in ((0, 39, 8), (5.5, 60.2, 16), (-3, 10, 4)):
        assert_same(decoder.temporal_sampling(frames, start, end, n),
                    jax_decoder.temporal_sampling(frames, start, end, n))


def test_sort_boxes_sorted_matches_jax():
    rs = np.random.RandomState(4)
    frames = []
    for t in range(9):
        n = rs.randint(0, 5)  # empty frames included
        ids = rs.randint(0, 8, (n, 1))
        frames.append(np.concatenate([rs.rand(n, 4), ids], axis=1)
                      if n else np.empty([0, 5]))
    for O, saved in ((4, [0, 1]), (2, ()), (6, [3, 1])):
        assert_same(sort_boxes_sorted(frames, O, saved),
                    jax_sort(frames, O, saved))
    assert_same(sort_boxes_sorted([np.empty([0, 5])] * 3, 4),
                jax_sort([np.empty([0, 5])] * 3, 4))


def test_zero_empty_boxes_matches_jax():
    from focus_tpu.utils.box_ops import zero_empty_boxes_np as jax_zero

    boxes = np.random.RandomState(6).randn(5, 3, 4).astype(np.float32)
    for fmt in ("cxcywh", "xyxy"):
        assert_same(zero_empty_boxes_np(boxes, fmt), jax_zero(boxes, fmt))


def _no_native(monkeypatch):
    """The JAX dataset takes its PIL path, the one the port has."""
    import focus_tpu.native

    monkeypatch.setattr(focus_tpu.native, "available", lambda: False)


def _all_items(ds):
    return [ds[i] for i in range(len(ds))]


@pytest.mark.parametrize("mode,boxes,device_preprocess", [
    ("test", "detectron2", True),
    ("test", "annotated", True),
    ("test", "none", False),
    ("val", "detectron2", True),
    ("val", "annotated", False),
])
def test_ssv2_matches_jax(tmp_path, monkeypatch, mode, boxes,
                          device_preprocess):
    from focus_tpu.datasets.ssv2 import Ssv2 as JaxSsv2
    from focus_tpu_torch.datasets.ssv2 import Ssv2

    _no_native(monkeypatch)
    root = str(tmp_path)
    make_ssv2_tree(root, num_videos=3, num_frames=12, size=48)
    write_ssv2_bbox_jsons(root)
    cfg = get_cfg()
    cfg.MODEL.ARCH = "slow"
    cfg.SSV2.DATA_ROOT = cfg.SSV2.SPLITS_ROOT = root
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_JITTER_SCALES = [40, 56]
    cfg.DATA.TRAIN_CROP_SIZE = 36
    cfg.DATA.TEST_CROP_SIZE = 40
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
    cfg.TEST.NUM_SPATIAL_CROPS = 3
    cfg.ORVIT.ENABLE = boxes != "none"
    cfg.ORVIT.O = 4
    cfg.SSV2.BOXES_FORMAT = "detectron2" if boxes == "none" else boxes
    cfg.TPU.DEVICE_PREPROCESS = device_preprocess
    got = _all_items(Ssv2(cfg, mode))
    want = _all_items(JaxSsv2(jax_cfg_like(cfg), mode))
    assert len(got) == (18 if mode == "test" else 3)
    assert_same(got, want)
    video, _, _, meta = got[0]
    assert video.shape == ((4, 40, 40, 3) if mode == "test" else (4, 36, 36, 3))
    assert video.dtype == (np.uint8 if device_preprocess else np.float32)
    assert ("orvit_bboxes" in meta) == (boxes != "none")


def ek_cfg(root, crop=40, frames=8):
    ann, name, visual = make_ek_tree(root)
    cfg = get_cfg()
    cfg.MODEL.ARCH = "slow"
    cfg.EPICKITCHENS.ANNOTATIONS_DIR = ann
    cfg.EPICKITCHENS.TEST_LIST = cfg.EPICKITCHENS.VAL_LIST = name
    cfg.EPICKITCHENS.VISUAL_DATA_DIR = visual
    cfg.DATA.NUM_FRAMES = frames
    cfg.DATA.SAMPLING_RATE = 4
    cfg.DATA.TRAIN_JITTER_SCALES = [44, 56]
    cfg.DATA.TRAIN_CROP_SIZE = 36
    cfg.DATA.TEST_CROP_SIZE = crop
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 10
    cfg.TEST.NUM_SPATIAL_CROPS = 3
    cfg.ORVIT.ENABLE = True
    cfg.ORVIT.O = 4
    return cfg


@pytest.mark.parametrize("mode", ["test", "val"])
def test_epickitchens_matches_jax(tmp_path, mode):
    from focus_tpu.datasets.epickitchens import Epickitchens as JaxEK
    from focus_tpu_torch.datasets.epickitchens import Epickitchens

    cfg = ek_cfg(str(tmp_path))
    got = _all_items(Epickitchens(cfg, mode))
    want = _all_items(JaxEK(jax_cfg_like(cfg), mode))
    assert len(got) == (60 if mode == "test" else 2)
    assert_same(got, want)
    video, labels, index, meta = got[-1]
    assert video.shape == ((8, 40, 40, 3) if mode == "test" else (8, 36, 36, 3))
    assert video.dtype == np.uint8
    assert labels == {"verb": 41, "noun": 250} and index == len(got) - 1
    assert meta["orvit_bboxes"].shape == (8, 4, 4)
    # the hand slots and some object slots are filled, degenerate boxes zeroed
    boxes = np.stack([g[3]["orvit_bboxes"] for g in got])
    assert (boxes[..., :2, 2] > 0).any() and (boxes[..., 2:, 2] > 0).any()
    assert not ((boxes[..., 2] <= 0) & (boxes.any(-1))).any()


class DictDataset:
    """EPIC-Kitchens-shaped samples: uint8 frames, dict labels, an index,
    dict metadata."""

    def __len__(self):
        return 11

    def __getitem__(self, i):
        rs = np.random.RandomState(i)
        return (rs.randint(0, 256, (2, 4, 4, 3)).astype(np.uint8),
                {"verb": np.int32(i % 5), "noun": np.int32(i % 7)},
                np.int32(i),
                {"orvit_bboxes": rs.rand(2, 3, 4).astype(np.float32)})


class ClassificationDataset:
    def __len__(self):
        return 13

    def __getitem__(self, i):
        rs = np.random.RandomState(i)
        return (rs.rand(2, 4, 4, 3).astype(np.float32), np.int32(i % 3),
                np.int32(i), {})


@pytest.mark.parametrize("dataset", [DictDataset, ClassificationDataset])
@pytest.mark.parametrize("shuffle,drop_last,pad_last", [
    (False, False, True), (True, True, False), (True, False, True),
    (False, False, False),
])
def test_loader_batches_match_jax(dataset, shuffle, drop_last, pad_last):
    ds = dataset()
    port = loader.DataLoader(ds, 4, shuffle, drop_last, num_workers=3,
                             seed=5, device="cpu", prefetch=2,
                             pad_last=pad_last)
    ref = jax_loader.DataLoader(ds, 4, shuffle, drop_last, num_workers=3,
                                seed=5, sharding=None, prefetch=2,
                                pad_last=pad_last)
    for epoch in (0, 3):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port) == len(ref)
        assert_same(got, want)
        for batch in got:
            for leaf in loader._leaves(batch):
                assert torch.is_tensor(leaf) and leaf.device.type == "cpu"
        ids = np.concatenate([b[2].numpy() for b in got])
        if pad_last and not drop_last:  # the last batch's own rows repeat
            last = len(ds) % 4
            assert (ids == -1).sum() == min(last, 4 - last)
        if drop_last:
            assert len(ids) == (len(ds) // 4) * 4


def test_loader_order_under_thread_contention():
    """More workers than cores, samples finishing out of order, a short
    switch interval: every batch still holds its indices in order."""
    class Slow(DictDataset):
        def __len__(self):
            return 50

        def __getitem__(self, i):
            time.sleep(np.random.RandomState(i).rand() * 2e-3)
            return super().__getitem__(i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        port = loader.DataLoader(Slow(), 4, True, False, num_workers=32,
                                 seed=1, device="cpu", prefetch=1,
                                 pad_last=True)
        want = jax_loader.DataLoader(Slow(), 4, True, False, num_workers=1,
                                     seed=1, sharding=None, prefetch=1,
                                     pad_last=True)
        got = list(port)
    finally:
        sys.setswitchinterval(interval)
    assert_same(got, list(want))


def test_loader_keeps_uint8_and_raises_without_cuda():
    batch = next(iter(loader.DataLoader(DictDataset(), 4, False, False,
                                        device="cpu")))
    assert batch[0].dtype == torch.uint8 and batch[2].dtype == torch.int32
    assert batch[1]["verb"].dtype == torch.int32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            loader.DataLoader(DictDataset(), 4, False, False)


def test_loader_stops_when_the_consumer_leaves_early():
    """A consumer that stops after one batch (as a forward that raises
    does) ends the producer thread and its workers, with the queue full and
    batches still to make; the wait times are those of the batch taken."""
    class Many(DictDataset):
        def __len__(self):
            return 400

    port = loader.DataLoader(Many(), 4, False, False, num_workers=3,
                             device="cpu", prefetch=1)
    epoch = iter(port)
    first = next(epoch)
    assert first[2].tolist() == [0, 1, 2, 3]
    time.sleep(0.3)  # the producer fills the queue and blocks on it
    epoch.close()
    deadline = time.monotonic() + 10
    while any(t.name == loader.PRODUCER for t in threading.enumerate()):
        assert time.monotonic() < deadline, "the producer is still running"
        time.sleep(0.01)
    assert 0 < port.first_wait_seconds == port.wait_seconds
    full = list(port)
    assert len(full) == len(port) == 100
    assert port.first_wait_seconds <= port.wait_seconds


def test_loader_passes_dataset_errors_on():
    class Broken(DictDataset):
        def __getitem__(self, i):
            if i == 6:
                raise FileNotFoundError("frame 6")
            return super().__getitem__(i)

    with pytest.raises(FileNotFoundError, match="frame 6"):
        list(loader.DataLoader(Broken(), 4, False, False, device="cpu"))


@pytest.mark.parametrize("key,value,match", [
    ("NUM_SHARDS", 2, "more than one process"),
    ("DATA_LOADER.WORKER_BACKEND", "process", "WORKER_BACKEND"),
    ("MULTIGRID.SHORT_CYCLE", True, "SHORT_CYCLE"),
    ("AUG.NUM_SAMPLE", 2, "NUM_SAMPLE"),
])
def test_construct_loader_raises_on_unported_options(key, value, match):
    cfg = get_cfg()
    cfg.TRAIN.DATASET = "synthetic_classification"
    cfg.AUG.ENABLE = True
    *path, name = key.split(".")
    node = cfg
    for part in path:
        node = getattr(node, part)
    setattr(node, name, value)
    with pytest.raises(NotImplementedError, match=match):
        loader.construct_loader(cfg, "train", device="cpu")


class StackedViews(DictDataset):
    """Samples of two views stacked on a leading axis (repeated
    augmentation): [2, T, H, W, C] frames, two labels, two indices."""

    def __getitem__(self, i):
        video, labels, index, _ = super().__getitem__(i)
        return (np.stack([video, 255 - video]),
                np.full((2,), labels["verb"], np.int32),
                np.full((2,), index, np.int32), {})


def test_loader_flattens_stacked_views_as_jax():
    """``flatten_samples`` 2 (AUG.NUM_SAMPLE 2 on a dataset that stacks
    its views, as Kinetics does): every leaf [B, 2, ...] becomes
    [B * 2, ...], each sample's views adjacent, bit-equal to JAX's loader;
    ``real_rows`` counts clips."""
    port = loader.DataLoader(StackedViews(), 4, True, True, num_workers=2,
                             seed=3, device="cpu", flatten_samples=2)
    ref = jax_loader.DataLoader(StackedViews(), 4, True, True, num_workers=2,
                                seed=3, sharding=None, flatten_samples=2)
    got, want = list(port), list(ref)
    assert len(got) == len(want) == 2
    assert_same(got, want)
    video, labels, index, meta = got[0]
    assert video.shape == (8, 2, 4, 4, 3) and labels.shape == (8,)
    assert index[0::2].tolist() == index[1::2].tolist() and meta == {}
    assert port.real_rows(0) == 8


def test_construct_loader_split_table():
    cfg = get_cfg()
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "synthetic_classification"
    cfg.TRAIN.BATCH_SIZE, cfg.TEST.BATCH_SIZE = 6, 5
    cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE = 2, 8
    cfg.DATA.TEST_CROP_SIZE = 8
    got = {s: loader.construct_loader(cfg, s, device="cpu")
           for s in ("train", "val", "test")}
    assert [(g.batch_size, g.shuffle, g.drop_last, g.pad_last)
            for g in got.values()] == [(6, True, True, False),
                                       (6, False, False, True),
                                       (5, False, False, True)]
    assert len(got["train"]) == 64 // 6 and len(got["test"]) == 4
