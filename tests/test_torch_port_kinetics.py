"""The port's Kinetics data path against the JAX package's on the same
inputs: the cv2 video readers on an mp4 written under ``tmp_path``, the
uint8 resize (through cv2, and in numpy without it) against
``cv2.resize``, random erasing, the ``Kinetics`` dataset in val, test and
train modes (the MViT recipe with repeated augmentation), the loader's
flattened batches, and a tiny MViT Kinetics yaml through
``focus_tpu_torch.tools.run_net``. Host numpy
in both packages, so the tolerance is bit-equality (same values, same
dtypes).

The train mode draws from an unseeded ``RandomState(None)``, as the JAX
package's does; these tests alone seed it (in both packages at once), and
seed numpy's global generator, from which RandAugment draws the sign of
its enhancement ops, before each item."""

import os

import numpy as np
import pytest
import torch

from focus_tpu_torch.config import get_cfg
from focus_tpu_torch.datasets import decoder, loader
from focus_tpu_torch.datasets import transform as xf
from focus_tpu_torch.datasets.random_erasing import RandomErasing
from synthetic_data import make_kinetics_tree
from test_torch_port_datasets import assert_same
from torch_port_trees import jax_cfg_like

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AA_TYPE = "rand-m7-n4-mstd0.5-inc1"  # configs/Kinetics/MVIT_B_16x4_CONV.yaml's


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _SeededRandomState(np.random.RandomState):
    def __init__(self, seed=None):
        super().__init__(99 if seed is None else seed)


@pytest.fixture(scope="module")
def k400(tmp_path_factory):
    """Four mp4 videos of 40 frames at 48 x 64 (cv2's mp4v) and their
    train / val / test lists."""
    root = str(tmp_path_factory.mktemp("k400"))
    make_kinetics_tree(root, num_videos=4, num_frames=40, size=48)
    # a non-square video, so that the short side and the crops differ
    path = os.path.join(root, "wide.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (64, 48))
    rs = np.random.RandomState(1)
    for _ in range(40):
        w.write(rs.randint(0, 255, (48, 64, 3), np.uint8))
    w.release()
    for split in ("train", "val", "test"):
        with open(os.path.join(root, f"{split}.csv"), "a") as f:
            f.write(f"{path} 2\n")
    return root


# ---- the readers -------------------------------------------------------------

@pytest.mark.parametrize("case", ["whole", "probe", "window", "random_clip",
                                  "view_3_of_10", "offset", "not_selective"])
def test_readers_match_jax(k400, case):
    """Each cv2 reader of ``datasets/decoder.py`` bit-equal to JAX's on the
    same file: the whole decode, the probe, a window, and ``decode``'s
    clip at a seeded random start, at a test view, with offset sampling
    and without the selective seek."""
    from focus_tpu.datasets import decoder as jd

    path = os.path.join(k400, "wide.mp4")
    out = {}
    for name, mod in (("port", decoder), ("jax", jd)):
        if case == "whole":
            out[name] = mod.decode_video_cv2(path)
        elif case == "probe":
            out[name] = mod.probe_video_cv2(path)
        elif case == "window":
            out[name] = mod.decode_window_cv2(path, 7, 21)
        else:
            kw = {"random_clip": dict(clip_idx=-1,
                                      rng=np.random.RandomState(4)),
                  "view_3_of_10": dict(clip_idx=3, num_clips=10),
                  "offset": dict(clip_idx=0, num_clips=1, use_offset=True),
                  "not_selective": dict(clip_idx=2, num_clips=4,
                                        selective=False)}[case]
            out[name] = mod.decode(path, 2, 8, target_fps=30, **kw)
    assert_same(out["port"], out["jax"])
    if case in ("whole", "window"):
        frames = out["port"][0] if case == "whole" else out["port"]
        assert frames.dtype == np.uint8 and frames.shape[1:] == (48, 64, 3)
    if case == "whole":
        assert out["port"][0].shape[0] == 40
    if case not in ("whole", "probe", "window"):
        assert out["port"].shape == (8, 48, 64, 3)
    assert decoder.decode(os.path.join(k400, "missing.mp4"), 2, 8) is None


# ---- the uint8 resize ----------------------------------------------------------

@pytest.mark.parametrize("src,dst", [
    ((48, 64), (224, 299)),     # upscale
    ((720, 1280), (256, 455)),  # downscale, the short side to 256
    ((256, 340), (128, 170)),   # exactly half: cv2 averages 2 x 2 blocks
    ((5, 3), (17, 2)),          # the borders' clamped taps
    ((31, 17), (1, 1)),
])
def test_uint8_resize_matches_cv2(src, dst, monkeypatch):
    """``transform._resize_frames_linear`` on uint8 frames bit-equal to
    ``cv2.resize(..., INTER_LINEAR)`` frame by frame and to the JAX
    package's resize, through cv2 and, with cv2 taken away, through the
    numpy fixed-point path; one and three channels."""
    import focus_tpu.datasets.transform as jax_xf

    rs = np.random.RandomState(sum(src) + sum(dst))
    for c in (3, 1):
        frames = rs.randint(0, 256, (2, *src, c)).astype(np.uint8)
        want = np.stack([cv2.resize(f, dst[::-1],
                                    interpolation=cv2.INTER_LINEAR)
                         .reshape(*dst, c) for f in frames])
        assert_same(xf._resize_frames_linear(frames, *dst), want)
        with monkeypatch.context() as m:
            m.setattr(xf, "_cv2", lambda: None)
            got = xf._resize_frames_linear(frames, *dst)
            with pytest.raises(ImportError):
                xf._resize_frames_linear(frames.astype(np.float32), *dst)
        assert_same(got, want)
        assert_same(got, jax_xf._resize_frames_linear(frames, *dst))


# ---- random erasing ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("mode", ["const", "rand", "pixel"])
def test_random_erasing_matches_jax(mode, dtype):
    """``RandomErasing`` bit-equal to JAX's from one seed: one to three
    boxes, in every frame (cube) or one, uint8 fills ``(z * std + mean) *
    255`` rounded and clipped, float fills the normal draws."""
    from focus_tpu.datasets.random_erasing import RandomErasing as JaxRE

    rs = np.random.RandomState(7)
    if dtype == "uint8":
        frames = rs.randint(0, 256, (4, 40, 48, 3)).astype(np.uint8)
    else:
        frames = rs.randn(4, 40, 48, 3).astype(np.float32)
    erased = 0
    for seed in range(6):
        kw = dict(probability=0.9, mode=mode, max_count=1 + seed % 3,
                  cube=seed % 2 == 0, mean=(0.45, 0.4, 0.5),
                  std=(0.225, 0.2, 0.25))
        got = RandomErasing(**kw)(frames, rng=np.random.RandomState(seed))
        want = JaxRE(**kw)(frames, rng=np.random.RandomState(seed))
        assert_same(got, want)
        erased += not np.array_equal(got, frames)
    assert erased >= 3


# ---- the dataset ----------------------------------------------------------------

def _kinetics_cfg(root, case):
    cfg = get_cfg()
    cfg.DATA.PATH_TO_DATA_DIR = root
    cfg.DATA.NUM_FRAMES = 8
    cfg.DATA.SAMPLING_RATE = 2
    cfg.DATA.TRAIN_JITTER_SCALES = [40, 56]
    cfg.DATA.TRAIN_CROP_SIZE = 36
    cfg.DATA.TEST_CROP_SIZE = 36
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
    cfg.TEST.NUM_SPATIAL_CROPS = 3
    cfg.MODEL.ARCH = "mvit"
    if case in ("test_slowfast", "train_slowfast"):
        cfg.MODEL.ARCH = "slowfast"
        cfg.SLOWFAST.ALPHA = 4
    if case == "test_slowfast":
        cfg.DATA.TEST_CROP_SIZE = 256  # the 256 row of the crop table
        cfg.DATA.TRAIN_JITTER_SCALES = [256, 320]
    if case == "val_offset":
        cfg.DATA.USE_OFFSET_SAMPLING = True
    if case.startswith("train_aug"):
        cfg.AUG.ENABLE = True
        cfg.AUG.NUM_SAMPLE = 2
        cfg.AUG.AA_TYPE = AA_TYPE
        cfg.AUG.INTERPOLATION = "bicubic"
        cfg.AUG.RE_PROB = 0.9
        cfg.AUG.RE_MODE = "pixel"
        cfg.DATA.TRAIN_JITTER_SCALES_RELATIVE = [0.08, 1.0]
        cfg.DATA.TRAIN_JITTER_ASPECT_RELATIVE = [0.75, 1.3333]
        cfg.DATA.TRAIN_JITTER_MOTION_SHIFT = case == "train_aug_shift"
    if case == "train_float":
        cfg.TPU.DEVICE_PREPROCESS = False
    return cfg


@pytest.mark.parametrize("case", [
    "val", "val_offset", "test", "test_slowfast", "train_slowfast",
    "train_aug", "train_aug_shift", "train_float"])
def test_kinetics_items_match_jax(k400, monkeypatch, case):
    """Every item of ``Kinetics`` bit-equal to JAX's: val (and with offset
    sampling), test (2 temporal x 3 spatial views; SlowFast's pathways at
    the 256 crop), train (SlowFast; float frames normalised on the host),
    and the MViT recipe (RandAugment, the relative scale / aspect crop with
    and without motion shift, pixel random erasing) with NUM_SAMPLE 2
    views stacked, labels and indices ``np.full``."""
    from focus_tpu.datasets.kinetics import Kinetics as JaxKinetics
    from focus_tpu_torch.datasets.kinetics import Kinetics

    monkeypatch.setattr(np.random, "RandomState", _SeededRandomState)
    cfg = _kinetics_cfg(k400, case)
    mode = case.split("_")[0]
    port, ref = Kinetics(cfg, mode), JaxKinetics(jax_cfg_like(cfg), mode)
    assert len(port) == len(ref) == 5 * (6 if mode == "test" else 1)
    for i in range(len(port)):
        np.random.seed(i)
        got = port[i]
        np.random.seed(i)
        assert_same(got, ref[i])
    if case.startswith("train_aug"):
        video, labels, index, meta = got
        assert video.shape == (2, 8, 36, 36, 3) and video.dtype == np.uint8
        assert labels.tolist() == [2, 2] and index.tolist() == [4, 4]
        assert meta == {}
    if case == "test_slowfast":
        slow, fast = got[0]
        assert slow.shape == (2, 256, 256, 3) and fast.shape[0] == 8


def test_kinetics_retries_then_replaces(k400, monkeypatch):
    """Decode failures: retried, and from the third on a random video
    replaces the one asked for, as in JAX's; ten failures raise."""
    from focus_tpu.datasets import decoder as jd
    from focus_tpu.datasets.kinetics import Kinetics as JaxKinetics
    from focus_tpu_torch.datasets.kinetics import Kinetics

    cfg = _kinetics_cfg(k400, "val")
    out = {}
    for name, cls, mod in (("port", Kinetics, decoder),
                           ("jax", JaxKinetics, jd)):
        calls = []
        real = mod.decode

        def flaky(path, *args, **kwargs):
            calls.append(os.path.basename(path))
            return None if len(calls) <= 3 else real(path, *args, **kwargs)

        monkeypatch.setattr(mod, "decode", flaky)
        ds = cls(cfg if name == "port" else jax_cfg_like(cfg), "val")
        out[name] = (ds[1], calls)
        monkeypatch.setattr(mod, "decode", lambda *a, **k: None)
        with pytest.raises(RuntimeError, match="after retries"):
            ds[0]
    assert_same(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1]
    assert out["port"][1][:3] == ["vid1.mp4"] * 3
    assert out["port"][0][2] != 1  # the replacement's index


# ---- the loader ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mvit", "slowfast"])
def test_loader_flattens_repeated_augmentation_as_jax(k400, monkeypatch,
                                                      arch):
    """``construct_loader`` on the train split with AUG.NUM_SAMPLE 2:
    every leaf [B, 2, ...] flattened to [B * 2, ...] (both SlowFast
    pathways), each clip's two views adjacent with one label, bit-equal to
    JAX's batches over two epochs; precise BN's loader does not flatten;
    the val split never does."""
    import focus_tpu.datasets.loader as jax_loader

    monkeypatch.setattr(np.random, "RandomState", _SeededRandomState)
    cfg = _kinetics_cfg(k400, "train_aug")
    cfg.AUG.AA_TYPE = ""  # RandAugment's sign draws are global: racy
    cfg.MODEL.ARCH = arch
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.DATA_LOADER.NUM_WORKERS = 2
    port = loader.construct_loader(cfg, "train", device="cpu")
    ref = jax_loader.construct_loader(jax_cfg_like(cfg), "train")
    assert port.flatten_samples == ref.flatten_samples == 2
    for epoch in (0, 1):
        loader.shuffle_dataset(port, epoch)
        jax_loader.shuffle_dataset(ref, epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 2
        assert_same(got, want)
    video, labels, index, meta = got[0]
    first = video[0] if arch == "slowfast" else video
    assert first.shape[0] == 4 and labels.shape == (4,) and meta == {}
    assert labels[0::2].tolist() == labels[1::2].tolist()
    assert index[0::2].tolist() == index[1::2].tolist()
    assert port.real_rows(0) == 4
    precise = loader.construct_loader(cfg, "train", device="cpu",
                                      is_precise_bn=True)
    assert precise.flatten_samples == 1
    assert loader.construct_loader(cfg, "val", device="cpu").flatten_samples == 1


# ---- the yaml ------------------------------------------------------------------------

def test_kinetics_mvit_yaml_runs_on_the_port(tmp_path):
    """``configs/Kinetics/MVIT_B_16x4_CONV.yaml`` through the port's
    ``tools.run_net`` on the CPU with the zoo test's overrides (float32, 4
    blocks of 24, 64 px): RandAugment, the relative crops, random erasing
    and 2 repeated views a video, mixup in the step, then the test from
    the checkpoint it wrote."""
    from focus_tpu_torch.tools import run_net

    root = str(tmp_path / "k400")
    make_kinetics_tree(root, num_videos=8, num_frames=48, size=64)
    overrides = {
        "TPU.COMPUTE_DTYPE": "float32", "TENSORBOARD.ENABLE": "False",
        "DATA_LOADER.NUM_WORKERS": "2", "SOLVER.MAX_EPOCH": "1",
        "TRAIN.EVAL_PERIOD": "1", "TRAIN.CHECKPOINT_PERIOD": "1",
        "TRAIN.AUTO_RESUME": "False", "LOG_PERIOD": "1",
        "TRAIN.METHOD": "sup", "TEST.EVAL_TASK": "ar",
        "DATA.PATH_TO_DATA_DIR": root, "TRAIN.BATCH_SIZE": "8",
        "TEST.BATCH_SIZE": "8", "TEST.NUM_ENSEMBLE_VIEWS": "1",
        "TEST.NUM_SPATIAL_CROPS": "1", "DATA.NUM_FRAMES": "4",
        "DATA.SAMPLING_RATE": "2", "DATA.TRAIN_JITTER_SCALES": "[72,88]",
        "DATA.TRAIN_CROP_SIZE": "64", "DATA.TEST_CROP_SIZE": "64",
        "MODEL.NUM_CLASSES": "4", "MVIT.EMBED_DIM": "24",
        "MVIT.NUM_HEADS": "2", "MVIT.DEPTH": "4",
        "MVIT.DIM_MUL": "[[2, 2.0]]", "MVIT.HEAD_MUL": "[[2, 2.0]]",
        "MVIT.POOL_Q_STRIDE": "[[2, 1, 2, 2]]",
        "MVIT.POOL_KV_STRIDE_ADAPTIVE": "[1, 2, 2]",
        "OUTPUT_DIR": str(tmp_path / "out")}
    argv = ["--device", "cpu", "--cfg",
            os.path.join(REPO, "configs", "Kinetics", "MVIT_B_16x4_CONV.yaml")]
    for k, v in overrides.items():
        argv += [k, v]
    stats = run_net.main(argv)
    ckpts = sorted(os.listdir(tmp_path / "out" / "checkpoints"))
    assert ckpts == ["checkpoint_epoch_00001.pyth"]
    assert sorted(stats) == ["split", "top1_acc", "top5_acc"]
