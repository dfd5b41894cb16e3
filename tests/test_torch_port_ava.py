"""The port's AVA detection path against the JAX package on the CPU:
``datasets/ava_dataset.Ava`` items bit-equal to JAX's on a
``synthetic_data.make_ava_tree`` tree (train and val, ``ORVIT.ENABLE`` on
and off, a keyframe with more than 16 boxes; the SORT-linked box cache
equal), ``utils/ava_eval`` within 1e-10 of JAX's on seeded random cases,
``AVAMeter``'s mAP equal to JAX's (the official protocol and the buffered
ground truth), ``detection_loss`` against ``_detection_loss`` with and
without the accumulation denominator, RoIAlign ``aligned=False`` against
``focus_tpu/ops/roi_align.py``, and ``configs/AVA/SLOW_8x8_R50_SHORT.yaml``
through ``focus_tpu_torch.tools.run_net`` (train, validation, test) with
the JAX tester's stats on the port's checkpoint.

The train mode draws from an unseeded ``RandomState(None)``, as the JAX
package's does; these tests alone seed it, in both packages at once."""

import csv
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic_data as synth
from focus_tpu_torch.config import get_cfg
from test_ava_differential import _make_case
from test_torch_port_datasets import assert_same
from torch_port_trees import jax_cfg_like

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAP_ATOL = 1e-10
CROWDED = ("vid0", 903, 20)  # a keyframe with 20 boxes, 4 past MAX_BOXES


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _SeededRandomState(np.random.RandomState):
    def __init__(self, seed=None):
        super().__init__(99 if seed is None else seed)


def _add_crowded_keyframe(root):
    """CROWDED's boxes appended to the train ground truth and the val
    detections, each box its own, with labels cycling over the classes."""
    video, sec, n = CROWDED
    rs = np.random.RandomState(7)
    ann = os.path.join(root, "annotations")
    for fname, last in (("gt_train.csv", None), ("person_box_val.csv", 0.97)):
        with open(os.path.join(ann, fname), "a") as f:
            writer = csv.writer(f)
            for k in range(n):
                x1, y1 = rs.rand(2) * 0.5
                row = [video, sec, f"{x1:.3f}", f"{y1:.3f}",
                       f"{x1 + 0.2 + 0.01 * k:.3f}", f"{y1 + 0.3:.3f}"]
                writer.writerow(row + ([k % 4 + 1, 1] if last is None
                                       else ["", f"{last:.6f}"]))


@pytest.fixture(scope="module")
def ava_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ava"))
    synth.make_ava_tree(root, num_videos=3, num_frames=70, size=64,
                        num_classes=4)
    _add_crowded_keyframe(root)
    return root


def ava_overrides(root):
    """tests/test_ava_protocol.py's overrides of the AVA yaml."""
    return {
        "AVA.FRAME_DIR": os.path.join(root, "frames"),
        "AVA.FRAME_LIST_DIR": os.path.join(root, "frame_lists"),
        "AVA.ANNOTATION_DIR": os.path.join(root, "annotations"),
        "AVA.TRAIN_GT_BOX_LISTS": '["gt_train.csv"]',
        "AVA.TRAIN_PREDICT_BOX_LISTS": '["person_box_train.csv"]',
        "AVA.TEST_PREDICT_BOX_LISTS": '["person_box_val.csv"]',
        "AVA.GROUNDTRUTH_FILE": "gt_val.csv",
        "AVA.EXCLUSION_FILE": "excluded.csv",
        "AVA.LABEL_MAP_FILE": "labelmap.pbtxt",
        "AVA.DETECTION_SCORE_THRESH": "0.5",
        "MODEL.NUM_CLASSES": "4",
        "TRAIN.BATCH_SIZE": "8",
        "TEST.BATCH_SIZE": "8",
        "DATA.NUM_FRAMES": "4",
        "DATA.SAMPLING_RATE": "2",
        "DATA.TRAIN_JITTER_SCALES": "[72,88]",
        "DATA.TRAIN_CROP_SIZE": "64",
        "DATA.TEST_CROP_SIZE": "64",
    }


def ava_cfg(root, **extra):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "AVA",
                                     "SLOW_8x8_R50_SHORT.yaml"))
    opts = {**ava_overrides(root), **extra}
    cfg.merge_from_list([x for kv in opts.items() for x in kv])
    return cfg


# ---- the dataset -----------------------------------------------------------------

@pytest.mark.parametrize("split,orvit,arch", [
    ("train", False, "slowfast"), ("train", True, "slow"),
    ("val", False, "slow"), ("val", True, "slowfast"),
])
def test_ava_items_match_jax(ava_tree, monkeypatch, split, orvit, arch):
    """Every item of the split bit-equal to the JAX ``Ava``'s (the clip or
    its two pathways, the padded multi-hot labels, the index and the
    metadata: boxes, mask, ori_boxes, video_idx, sec and, under ORViT, the
    linked tracks as O boxes a frame); train with the colour augmentation.
    CROWDED's keyframe keeps its first 16 boxes in both. Under ORViT each
    package links the boxes itself (the cache removed between them) and
    the two caches are equal."""
    from focus_tpu.datasets.ava_dataset import Ava as JaxAva
    from focus_tpu_torch.datasets.ava_dataset import MAX_BOXES, Ava

    monkeypatch.setattr(np.random, "RandomState", _SeededRandomState)
    extra = {"MODEL.ARCH": arch, "ORVIT.ENABLE": str(orvit), "ORVIT.O": "3",
             "AVA.TRAIN_USE_COLOR_AUGMENTATION": "True"}
    cfg = ava_cfg(ava_tree, **extra)
    cache = os.path.join(ava_tree, "annotations", "linked_boxes")
    shutil.rmtree(cache, ignore_errors=True)
    want = JaxAva(jax_cfg_like(cfg), split)
    shutil.rmtree(cache, ignore_errors=True)
    got = Ava(cfg, split)
    assert len(got) == len(want) > 0
    if orvit:
        assert got.orvit_boxes.keys() == want.orvit_boxes.keys()
        for v in want.orvit_boxes:
            assert_same(got.orvit_boxes[v], want.orvit_boxes[v])
    crowded = [i for i, (v, s, e) in enumerate(got._keyframes)
               if got._video_idx_to_name[v] == CROWDED[0]
               and s == CROWDED[1]]
    assert len(crowded) == 1
    vidx, sec, entries = got._keyframes[crowded[0]]
    assert len(entries) > MAX_BOXES
    for i in range(len(got)):
        item = got[i]
        assert_same(item, want[i])
        metadata = item[3]
        assert ("orvit_bboxes" in metadata) == orvit
        if i == crowded[0]:
            assert metadata["boxes_mask"].sum() == MAX_BOXES


# ---- the evaluator and the meter -------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ava_eval_matches_jax(seed):
    """``run_evaluation`` on tests/test_ava_differential.py's randomised
    cases (exclusions, empty classes, duplicate detections, a key without
    ground truth): the mAP and every class's AP within 1e-10 of JAX's; and
    ``evaluate_ava_map`` / ``run_evaluation_from_buffers`` on buffered
    rows of the same boxes."""
    from focus_tpu.utils import ava_eval as jax_eval
    from focus_tpu_torch.utils import ava_eval

    categories, gt, det, excluded = _make_case(
        seed, with_exclusions=seed % 2 == 0, empty_class=seed != 1,
        duplicate_dets=seed != 2)
    ours = ava_eval.run_evaluation(categories, gt, det, excluded)
    ref = jax_eval.run_evaluation(categories, gt, det, excluded)
    assert sorted(ours) == sorted(ref)
    assert abs(ours["map"] - ref["map"]) <= MAP_ATOL
    assert ours["ap_per_class"].keys() == ref["ap_per_class"].keys()
    for c, ap in ref["ap_per_class"].items():
        assert abs(ours["ap_per_class"][c] - ap) <= MAP_ATOL

    rs = np.random.RandomState(seed)
    keys = sorted(gt[0])
    preds = [rs.rand(3, 6) for _ in keys]
    boxes = [np.asarray(det[0][k][:3] + [[0.1, 0.1, 0.4, 0.4]] * 3)[:3]
             for k in keys]
    masks = [np.array([1.0, 1.0, 0.0]) for _ in keys]
    truth = [(k, np.asarray(gt[0][k], np.float64),
              np.asarray(gt[1][k], np.int64)) for k in keys]
    a = ava_eval.run_evaluation_from_buffers(preds, boxes, masks, keys, 6,
                                             0.3, truth)
    b = jax_eval.run_evaluation_from_buffers(preds, boxes, masks, keys, 6,
                                             0.3, truth)
    assert abs(a["map"] - b["map"]) <= MAP_ATOL and 0.0 <= a["map"] <= 1.0


@pytest.mark.parametrize("protocol", [True, False])
def test_ava_meter_matches_jax(ava_tree, protocol):
    """AVAMeter on the same buffered batches (the val split's keys and
    boxes, seeded scores): under the official protocol (the tree's
    ground-truth CSV, exclusions and labelmap; mode "val" reads the mini
    ground truth, "test" the full one) and against the buffered ground
    truth where no annotation file is given: the mAP equal to JAX's."""
    from focus_tpu.utils.meters import AVAMeter as JaxAVAMeter
    from focus_tpu_torch.utils.ava_eval import make_image_key, read_csv
    from focus_tpu_torch.utils.meters import AVAMeter

    cfg = ava_cfg(ava_tree)
    if not protocol:
        cfg.AVA.ANNOTATION_DIR = ""
    names = ["vid0", "vid1", "vid2"]
    # one box of each keyframe on its ground truth, so some detections match
    truth = read_csv(os.path.join(ava_tree, "annotations", "gt_val.csv"))
    rs = np.random.RandomState(3)
    batches = []
    for v in range(3):
        for sec in (902, 903):
            preds = rs.rand(4, 16, 4).astype(np.float32)
            boxes = np.clip(rs.rand(4, 16, 4) * 0.6 + [0, 0, 0.3, 0.3],
                            0, 1).astype(np.float32)
            masks = (rs.rand(4, 16) < 0.5).astype(np.float32)
            labels = (rs.rand(4, 16, 4) < 0.4).astype(np.int32)
            keys = [make_image_key(names[v], sec)] * 4
            for y1, x1, y2, x2 in truth[0].get(keys[0], [])[:1]:
                boxes[0, 0], masks[0, 0] = [x1, y1, x2, y2], 1.0
            batches.append((preds, boxes, masks, keys, labels))
    for mode in ("val", "test"):
        meters = [AVAMeter(6, cfg, mode, video_idx_to_name=names),
                  JaxAVAMeter(6, jax_cfg_like(cfg), mode,
                              video_idx_to_name=names)]
        results = []
        for meter in meters:
            for b in batches:
                meter.update_stats(*b)
            results.append(meter.finalize_metrics())
        assert (meters[0].full_groundtruth is None) == (not protocol)
        assert results[0]["map"] == results[1]["map"]
        assert meters[0].full_map == meters[1].full_map
        # mode "val" under the protocol reads the mini ground truth, the
        # seconds divisible by 4, which 902 and 903 are not
        mini = protocol and mode == "val"
        assert results[0]["map"] == 0.0 if mini else (
            0.0 < results[0]["map"] <= 1.0)


# ---- the loss and RoIAlign -------------------------------------------------

@pytest.mark.parametrize("denom", [None, 2.5])
def test_detection_loss_matches_jax(denom):
    """The masked BCE and its gradient against ``_detection_loss`` (a
    probability at each clip bound included), with its box count and with
    the accumulation denominator."""
    from focus_tpu.engine.trainer import _detection_loss
    from focus_tpu_torch.engine.trainer import detection_loss

    rs = np.random.RandomState(1)
    preds = rs.rand(3, 16, 5).astype(np.float32)
    preds[0, 0, 0], preds[0, 0, 1] = 0.0, 1.0
    labels = (rs.rand(3, 16, 5) < 0.3).astype(np.int32)
    mask = (rs.rand(3, 16) < 0.6).astype(np.float32)
    jd = None if denom is None else jnp.float32(denom)
    want, jgrad = jax.value_and_grad(_detection_loss)(
        jnp.asarray(preds), jnp.asarray(labels), jnp.asarray(mask), jd)
    p = torch.from_numpy(preds).requires_grad_()
    got = detection_loss(p, torch.from_numpy(labels), torch.from_numpy(mask),
                         None if denom is None else torch.tensor(denom))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("aligned", [False, True])
def test_roi_align_matches_jax(aligned):
    """RoIAlign of boxes inside, across and outside a feature map, one of
    them narrower than a pixel (the unaligned form widens it to 1), against
    the JAX function at the same ``aligned``, within 1e-5."""
    from focus_tpu.ops.roi_align import roi_align as jax_roi_align
    from focus_tpu_torch.ops.roi_align import roi_align

    rs = np.random.RandomState(2)
    feat = rs.randn(2, 14, 14, 6).astype(np.float32)
    boxes = np.array([[[8.0, 8.0, 100.0, 150.0], [0.0, 0.0, 223.0, 223.0],
                       [50.0, 60.0, 54.0, 62.0], [200.0, 10.0, 260.0, 40.0]],
                      [[30.0, 30.0, 31.0, 200.0], [100.0, 100.0, 100.0, 100.0],
                       [-20.0, 5.0, 60.0, 90.0], [10.0, 10.0, 220.0, 30.0]]],
                     np.float32)
    want = np.asarray(jax_roi_align(jnp.asarray(feat), jnp.asarray(boxes),
                                    (7, 7), 1.0 / 16, aligned=aligned))
    got = roi_align(torch.from_numpy(feat), torch.from_numpy(boxes), (7, 7),
                    1.0 / 16, aligned).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(want).max() > 0.1


# ---- the yaml through the tools ----------------------------------------------

def test_ava_slow_yaml_runs_on_the_port(ava_tree, tmp_path):
    """``configs/AVA/SLOW_8x8_R50_SHORT.yaml`` through the port's
    ``tools.run_net`` on the CPU with tests/test_ava_protocol.py's
    overrides (float32, 4 frames, 64 px; width 8): one epoch of detection
    training, validation through AVAMeter, a checkpoint, then the test path
    scoring every val keyframe once under the official protocol. The JAX
    tester on the port's checkpoint scores the same boxes: the per-box
    probabilities within 1e-5, the same keys and boxes, and the mAP
    equal."""
    from focus_tpu.engine import tester as jax_tester
    from focus_tpu_torch.config.defaults import assert_and_infer_cfg
    from focus_tpu_torch.engine import tester
    from focus_tpu_torch.tools import run_net
    from focus_tpu_torch.utils.parser import load_config, parse_args

    overrides = {**ava_overrides(ava_tree),
                 "TRAIN.METHOD": "sup", "TEST.EVAL_TASK": "ar",
                 "SOLVER.MAX_EPOCH": "1", "SOLVER.WARMUP_EPOCHS": "0.0",
                 "TRAIN.EVAL_PERIOD": "1", "TRAIN.CHECKPOINT_PERIOD": "1",
                 "TRAIN.AUTO_RESUME": "False", "TPU.COMPUTE_DTYPE": "float32",
                 "TENSORBOARD.ENABLE": "False", "DATA_LOADER.NUM_WORKERS": "2",
                 "LOG_PERIOD": "1", "RESNET.WIDTH_PER_GROUP": "8",
                 "NUM_GPUS": "1", "OUTPUT_DIR": str(tmp_path / "out")}
    argv = ["--device", "cpu", "--cfg",
            os.path.join(REPO, "configs", "AVA", "SLOW_8x8_R50_SHORT.yaml"),
            "--exp_name", "zoo_ava"]
    for k, v in overrides.items():
        argv += [k, v]
    stats = run_net.main(argv)
    assert 0.0 <= stats["map"] <= 1.0 and stats["ap_per_class"]
    ckpt = str(tmp_path / "out" / "checkpoints" / "checkpoint_epoch_00001.pyth")
    assert os.listdir(tmp_path / "out" / "checkpoints") == [
        os.path.basename(ckpt)]
    cfg = assert_and_infer_cfg(load_config(parse_args(argv)))
    run = tester.run_test(cfg, device="cpu")
    assert run.stats["map"] == stats["map"]
    n_keyframes = len(run.meter.all_keys)
    assert run.clips == n_keyframes == len(set(run.meter.all_keys)) == 6

    jcfg = jax_cfg_like(cfg)
    jcfg.TRAIN.ENABLE = False
    jcfg.TEST.CHECKPOINT_FILE_PATH = ckpt
    jcfg.TEST.CHECKPOINT_TYPE = "pytorch"
    jcfg.OUTPUT_DIR = str(tmp_path / "jax")
    captured = []
    run_eval = jax_tester.perform_test_detection

    def capture(loader, state, eval_step, meter, cfg_):
        captured.append(meter)
        return run_eval(loader, state, eval_step, meter, cfg_)

    jax_tester.perform_test_detection = capture
    try:
        want = jax_tester.test(jcfg)
    finally:
        jax_tester.perform_test_detection = run_eval
    jm, = captured
    assert jm.all_keys == run.meter.all_keys
    np.testing.assert_array_equal(np.stack(jm.all_ori_boxes),
                                  np.stack(run.meter.all_ori_boxes))
    np.testing.assert_allclose(np.stack(run.meter.all_preds),
                               np.stack(jm.all_preds), atol=1e-5)
    assert want["map"] == stats["map"]
