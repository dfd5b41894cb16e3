"""Multi-view testing (counterpart of ``focus_tpu/engine/tester.py``).

Datasets replicate each video NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS
times; the per-clip probabilities of the eval forward are ensembled per
video by the test meter (sum or max): ``TestMeter``, or ``EPICTestMeter``
where the model has EPIC-Kitchens' verb and noun heads. The model builds
those heads for ``TRAIN.DATASET`` epickitchens, and the meter follows the
model; the JAX package keys the meter on ``TEST.DATASET``, which names the
same dataset in every config of the repo. Multi-label data
(``DATA.MULTI_LABEL``, Charades: multi-hot labels, ``MODEL.HEAD_ACT
sigmoid``) is ensembled the same way (``DATA.ENSEMBLE_METHOD max`` in its
yamls) and scored by the mean average precision. AVA detection
(``DETECTION.ENABLE``) scores each keyframe's boxes once, by the frame mAP
of ``AVAMeter`` (``run_detection_eval``, shared with validation).

Under data parallelism (``parallel/mesh.py``) each process runs its slice
of every global batch, and before any meter update the outputs, labels,
video indices and pad flags of every process are gathered, tiled
process-major (``gathered_host``, JAX ``_to_host``): every process holds
the same meter, every clip is counted once, and rank 0 writes the results
file. The pipe, seq, model and expert ranks of a data line run the same
clips, and the gathers run over the data line; under ``TPU.MESH.PIPE``
the eval forward is the pipeline's forward schedule alone
(``parallel/pipeline.py``).

``test`` returns the meter's stats, as the JAX package's does;
``run_test`` also returns the meter, the checkpoint report and the loop's
times (``TestRun``).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch

from focus_tpu_torch.datasets import loader as data_loader
from focus_tpu_torch.entry import EvalForward
from focus_tpu_torch.models.build import (
    build_model,
    maybe_zero_init_orvit,
    resolve_device,
)
from focus_tpu_torch.models.motionformer import EK_CLASSES
from focus_tpu_torch.ops.preprocess import device_normalize
from focus_tpu_torch.parallel import mesh
from focus_tpu_torch.utils import checkpoint as cu
from focus_tpu_torch.utils import logging
from focus_tpu_torch.utils.ava_eval import make_image_key
from focus_tpu_torch.utils.meters import AVAMeter, EPICTestMeter, TestMeter

logger = logging.get_logger(__name__)


@dataclasses.dataclass
class TestRun:
    """One test run: the meter's stats, the meter, the checkpoint report
    (None for a random init), the loop's seconds on the host clock (loader
    included), the seconds it waited for batches (``first_wait_seconds`` of
    them for the first batch), and the batches and clips it ran."""

    stats: dict
    meter: object
    checkpoint: Optional[dict]
    seconds: float
    wait_seconds: float
    first_wait_seconds: float
    batches: int
    clips: int


def _split_test_batch(batch):
    if isinstance(batch, (tuple, list)):
        if len(batch) >= 4:
            return batch[0], batch[1], batch[2], batch[3]
        if len(batch) == 3:
            return batch[0], batch[1], batch[2], {}
        return batch[0], batch[1], None, {}
    raise ValueError("test dataset must yield (video, label, index[, meta])")


def gathered_host(x):
    """A batch leaf of every process, tiled process-major, on the host as
    numpy (probabilities as float32); this process's alone without a
    process group."""
    if torch.is_floating_point(x):
        x = x.float()
    return mesh.all_gather_tiled(x, mesh.group("data")).cpu().numpy()


def make_eval_forward(model, cfg):
    """``fn(video, metadata)``: a batch normalised on its device (uint8
    frames; float frames pass unchanged) through ``entry.EvalForward``; a
    detection model scores the metadata's ``boxes``."""
    forward = EvalForward(model)
    detection = bool(cfg.DETECTION.ENABLE)

    def fn(video, metadata):
        return forward(device_normalize(video, cfg),
                       metadata.get("orvit_bboxes"),
                       metadata["boxes"] if detection else None)

    return fn


def run_detection_eval(loader, forward, meter, cur_epoch=None):
    """AVA's detection eval loop, for validation and the test (JAX
    ``run_detection_eval``; reference test_net.py:57-79): each batch's
    per-box probabilities, boxes in the original frame, masks, keys
    (``video,%04d``) and labels buffered in ``meter``, the frame mAP at the
    end. The loader's pad duplicates (sample index -1) are dropped before
    buffering: a duplicated detection of a matched box is a false positive
    to the greedy matcher. Returns (the meter's metrics, the keyframes
    buffered)."""
    names = meter.video_idx_to_name or []
    clips = 0
    for cur_iter, batch in enumerate(loader):
        video, labels, sample_idx, metadata = _split_test_batch(batch)
        meter.iter_tic()
        preds = forward(video, metadata)
        preds = preds[0] if isinstance(preds, tuple) else preds
        rows = [gathered_host(x) for x in (
            preds, metadata["boxes_mask"], metadata["ori_boxes"],
            metadata["video_idx"], metadata["sec"], labels)]
        if sample_idx is not None:
            keep = gathered_host(sample_idx) >= 0
            rows = [x[keep] for x in rows]
        preds_h, masks_h, ori_h, vidx_h, sec_h, labels_h = rows
        keys = [make_image_key(
            names[int(v)] if int(v) < len(names) else str(int(v)), int(s))
            for v, s in zip(vidx_h, sec_h)]
        meter.update_stats(preds_h, ori_h, masks_h, keys, labels_h)
        clips += len(keys)
        meter.iter_toc()
        meter.log_iter_stats(cur_epoch, cur_iter)
    return meter.finalize_metrics(), clips


def perform_test(test_loader, forward, test_meter, cfg):
    for cur_iter, batch in enumerate(test_loader):
        video, labels, video_idx, metadata = _split_test_batch(batch)
        test_meter.iter_tic()
        preds = forward(video, metadata)
        logits = preds[0] if isinstance(preds, tuple) else preds
        test_meter.update_stats(gathered_host(logits), gathered_host(labels),
                                gathered_host(video_idx))
        test_meter.iter_toc()
        test_meter.log_iter_stats(cur_iter, cfg.LOG_PERIOD)
    return test_meter.finalize_metrics()


def perform_test_ek(test_loader, forward, test_meter, cfg):
    for cur_iter, batch in enumerate(test_loader):
        video, labels, video_idx, metadata = _split_test_batch(batch)
        test_meter.iter_tic()
        _, both = forward(video, metadata)
        test_meter.update_stats(
            (gathered_host(both["verb"]), gathered_host(both["noun"])),
            {"verb": gathered_host(labels["verb"]),
             "noun": gathered_host(labels["noun"])},
            gathered_host(video_idx),
        )
        test_meter.iter_toc()
        test_meter.log_iter_stats(cur_iter, cfg.LOG_PERIOD)
    return test_meter.finalize_metrics()


def _ek_heads(cfg):
    """Whether the model has the verb and noun heads (as
    ``models/motionformer.py`` builds them)."""
    return cfg.TRAIN.DATASET == "epickitchens"


def _check_ported(cfg):
    """Raise on the test options that the port does not run yet."""
    mesh.check_mesh(cfg)
    tb = cfg.TENSORBOARD
    if (tb.ENABLE and not _ek_heads(cfg)
            and (tb.CONFUSION_MATRIX.ENABLE or tb.HISTOGRAM.ENABLE)):
        raise NotImplementedError(
            "TENSORBOARD.CONFUSION_MATRIX / HISTOGRAM: the eval panels come "
            "with the visualization slice of the port"
        )
    if getattr(cfg.MODEL, "LOAD_IN_PRETRAIN", ""):
        raise NotImplementedError(
            "MODEL.LOAD_IN_PRETRAIN: timm-format image weights are not read "
            "by the port yet"
        )


def test(cfg, device="cuda"):
    """Test ``cfg``'s model on every view of the test split and return the
    meter's stats; on ``device`` (CUDA unless the caller asks for the
    CPU)."""
    return run_test(cfg, device).stats


def run_test(cfg, device="cuda") -> TestRun:
    """``test``, returning the whole ``TestRun``."""
    device = resolve_device(device)
    _check_ported(cfg)
    np.random.seed(cfg.RNG_SEED)
    torch.manual_seed(cfg.RNG_SEED)
    logging.setup_logging(cfg.OUTPUT_DIR)
    logger.info("Test with config:")
    logger.info(cfg.dump())

    test_loader = data_loader.construct_loader(cfg, "test", device)
    logger.info(f"Testing model for {len(test_loader)} iterations")
    model = build_model(cfg, device)
    maybe_zero_init_orvit(cfg, model)
    report = cu.load_test_checkpoint(cfg, model)
    forward = make_eval_forward(model, cfg)
    if cfg.DETECTION.ENABLE:
        return perform_test_detection(cfg, test_loader, forward, report)

    num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    num_videos = len(test_loader.dataset) // num_clips
    assert len(test_loader.dataset) % num_clips == 0, (
        len(test_loader.dataset), num_clips,
    )
    t0 = time.perf_counter()
    if _ek_heads(cfg):
        test_meter = EPICTestMeter(
            num_videos, num_clips, EK_CLASSES, len(test_loader),
            cfg.DATA.ENSEMBLE_METHOD,
        )
        stats = perform_test_ek(test_loader, forward, test_meter, cfg)
    else:
        test_meter = TestMeter(
            num_videos,
            num_clips,
            cfg.MODEL.NUM_CLASSES,
            len(test_loader),
            cfg.DATA.MULTI_LABEL,
            cfg.DATA.ENSEMBLE_METHOD,
        )
        stats = perform_test(test_loader, forward, test_meter, cfg)
    run = TestRun(stats=stats, meter=test_meter, checkpoint=report,
                  seconds=time.perf_counter() - t0,
                  wait_seconds=test_loader.wait_seconds,
                  first_wait_seconds=test_loader.first_wait_seconds,
                  batches=len(test_loader), clips=len(test_loader.dataset))
    if (logging.is_master_process() and cfg.TEST.SAVE_RESULTS_PATH
            and isinstance(test_meter, TestMeter)):
        # pickle of [preds, labels]
        save_path = os.path.join(cfg.OUTPUT_DIR, cfg.TEST.SAVE_RESULTS_PATH)
        with open(save_path, "wb") as f:
            pickle.dump(
                [np.asarray(test_meter.video_preds),
                 np.asarray(test_meter.video_labels)], f,
            )
        logger.info(f"Successfully saved prediction results to {save_path}")
    return run


def perform_test_detection(cfg, test_loader, forward, report) -> TestRun:
    """The AVA test: every keyframe of the test split once through
    ``run_detection_eval``; the stats are the meter's metrics (``map``,
    ``ap_per_class``), as the JAX tester returns them."""
    meter = AVAMeter(len(test_loader), cfg, "test",
                     video_idx_to_name=test_loader.dataset._video_idx_to_name)
    t0 = time.perf_counter()
    stats, clips = run_detection_eval(test_loader, forward, meter)
    return TestRun(stats=stats, meter=meter, checkpoint=report,
                   seconds=time.perf_counter() - t0,
                   wait_seconds=test_loader.wait_seconds,
                   first_wait_seconds=test_loader.first_wait_seconds,
                   batches=len(test_loader), clips=clips)
