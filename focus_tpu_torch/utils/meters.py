"""Meters (counterpart of ``focus_tpu/utils/meters.py``): the timers, the
windowed scalar, the train loop's ``TrainMeter``, ``ValMeter`` and
``EPICValMeter`` (the same json lines as the JAX package's), and the
multi-view ensembles of the test path, ``TestMeter`` and ``EPICTestMeter``,
the slot trainer's running average ``MetricTracker``, and ``AVAMeter``,
AVA's frame mAP under the official protocol where the annotation files
exist, else against the ground truth buffered from the batches.
The JAX train loop logs EPIC-Kitchens training through ``TrainMeter`` (no
top-k), so ``EPICTrainMeter`` is not ported.

Timing is wall-clock on the host; the train loop brings its stats to the
host once per LOG_PERIOD, where the meters see them.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from focus_tpu_torch.utils import logging, metrics

logger = logging.get_logger(__name__)


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._start = time.perf_counter()
        self._paused = None
        self._total = 0.0

    def pause(self):
        if self._paused is None:
            self._total += time.perf_counter() - self._start
            self._paused = True

    def resume(self):
        self._start = time.perf_counter()
        self._paused = None

    def seconds(self) -> float:
        if self._paused is None:
            return self._total + (time.perf_counter() - self._start)
        return self._total


class ScalarMeter:
    """Windowed scalar tracker (reference meters.py:411-459)."""

    def __init__(self, window_size: int = 10):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def reset(self):
        self.deque.clear()
        self.total = 0.0
        self.count = 0

    def add_value(self, value: float):
        self.deque.append(value)
        self.count += 1
        self.total += value

    def get_win_median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    def get_win_avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    def get_global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricTracker:
    """Running average (reference meters.py:1445-1464)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class EpochTimer:
    """(reference meters.py:1302-1354)"""

    def __init__(self):
        self.timer = Timer()
        self.epoch_times = []

    def reset(self):
        self.timer.reset()
        self.epoch_times = []

    def epoch_tic(self):
        self.timer.reset()

    def epoch_toc(self):
        self.timer.pause()
        self.epoch_times.append(self.timer.seconds())

    def last_epoch_time(self):
        return self.epoch_times[-1]

    def avg_epoch_time(self):
        return float(np.mean(self.epoch_times))

    def median_epoch_time(self):
        return float(np.median(self.epoch_times))


class TrainMeter:
    """Iteration/epoch statistics for supervised training
    (reference meters.py:462-613); a MoE model's load-balance value
    (``moe_aux``) beside the loss in the iteration lines."""

    def __init__(self, epoch_iters: int, cfg):
        self.cfg = cfg
        self.epoch_iters = epoch_iters
        self.max_iter = cfg.SOLVER.MAX_EPOCH * epoch_iters
        self.iter_timer = Timer()
        self.data_timer = Timer()
        self.net_timer = Timer()
        self.loss = ScalarMeter(cfg.LOG_PERIOD)
        self.loss_total = 0.0
        self.lr = None
        self.mb_top1_err = ScalarMeter(cfg.LOG_PERIOD)
        self.mb_top5_err = ScalarMeter(cfg.LOG_PERIOD)
        self.moe_aux = ScalarMeter(cfg.LOG_PERIOD)
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0

    def reset(self):
        self.loss.reset()
        self.moe_aux.reset()
        self.loss_total = 0.0
        self.lr = None
        self.mb_top1_err.reset()
        self.mb_top5_err.reset()
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0

    def iter_tic(self):
        self.iter_timer.reset()
        self.data_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()
        self.net_timer.pause()

    def data_toc(self):
        self.data_timer.pause()
        self.net_timer.reset()

    def update_stats(self, top1_err, top5_err, loss, lr, mb_size,
                     moe_aux=None):
        self.loss.add_value(loss)
        if moe_aux is not None:
            self.moe_aux.add_value(moe_aux)
        self.lr = lr
        self.loss_total += loss * mb_size
        self.num_samples += mb_size
        if top1_err is not None:
            self.mb_top1_err.add_value(top1_err)
            self.mb_top5_err.add_value(top5_err)
            self.num_top1_mis += top1_err * mb_size
            self.num_top5_mis += top5_err * mb_size

    def log_iter_stats(self, cur_epoch: int, cur_iter: int):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        stats = {
            "_type": "train_iter",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.epoch_iters}",
            "dt": self.iter_timer.seconds(),
            "dt_data": self.data_timer.seconds(),
            "dt_net": self.net_timer.seconds(),
            "loss": self.loss.get_win_median(),
            "lr": self.lr,
        }
        if self.mb_top1_err.count > 0:
            stats["top1_err"] = self.mb_top1_err.get_win_median()
            stats["top5_err"] = self.mb_top5_err.get_win_median()
        if self.moe_aux.count > 0:
            stats["moe_aux"] = self.moe_aux.get_win_median()
        logging.log_json_stats(stats)

    def log_epoch_stats(self, cur_epoch: int):
        stats = {
            "_type": "train_epoch",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "loss": self.loss_total / max(self.num_samples, 1),
            "lr": self.lr,
        }
        if self.num_samples > 0 and self.num_top1_mis:
            stats["top1_err"] = self.num_top1_mis / self.num_samples
            stats["top5_err"] = self.num_top5_mis / self.num_samples
        logging.log_json_stats(stats)


class ValMeter:
    """(reference meters.py:616-759). Under ``DATA.MULTI_LABEL`` the epoch
    is scored by the mean average precision of the kept probabilities and
    multi-hot labels (``map``, and the best so far ``max_map``) instead of
    top-k errors, as the reference's val meter and the JAX test meter score
    such data."""

    def __init__(self, max_iter: int, cfg):
        self.cfg = cfg
        self.multi_label = bool(cfg.DATA.MULTI_LABEL)
        self.map = None
        self.max_map = 0.0
        self.max_iter = max_iter
        self.iter_timer = Timer()
        self.mb_top1_err = ScalarMeter(cfg.LOG_PERIOD)
        self.mb_top5_err = ScalarMeter(cfg.LOG_PERIOD)
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0
        self.all_preds = []
        self.all_labels = []
        self.min_top1_err = 100.0
        self.min_top5_err = 100.0

    def reset(self):
        self.mb_top1_err.reset()
        self.mb_top5_err.reset()
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0
        self.all_preds = []
        self.all_labels = []
        self.map = None

    def iter_tic(self):
        self.iter_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()

    def update_stats(self, top1_err, top5_err, mb_size):
        self.mb_top1_err.add_value(top1_err)
        self.mb_top5_err.add_value(top5_err)
        self.num_top1_mis += top1_err * mb_size
        self.num_top5_mis += top5_err * mb_size
        self.num_samples += mb_size

    def update_predictions(self, preds, labels):
        self.all_preds.append(np.asarray(preds))
        self.all_labels.append(np.asarray(labels))

    def log_iter_stats(self, cur_epoch: int, cur_iter: int):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        stats = {
            "_type": "val_iter",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.max_iter}",
            "time_diff": self.iter_timer.seconds(),
        }
        if not self.multi_label:
            stats["top1_err"] = self.mb_top1_err.get_win_median()
            stats["top5_err"] = self.mb_top5_err.get_win_median()
        logging.log_json_stats(stats)

    def log_epoch_stats(self, cur_epoch: int):
        stats = {
            "_type": "val_epoch",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
        }
        if self.multi_label:
            if self.all_preds:
                self.map = metrics.mean_ap(np.concatenate(self.all_preds),
                                           np.concatenate(self.all_labels))
                self.max_map = max(self.max_map, self.map)
                stats.update({"map": self.map, "max_map": self.max_map})
        elif self.num_samples > 0:
            top1 = self.num_top1_mis / self.num_samples
            top5 = self.num_top5_mis / self.num_samples
            self.min_top1_err = min(self.min_top1_err, top1)
            self.min_top5_err = min(self.min_top5_err, top5)
            stats.update(
                {
                    "top1_err": top1,
                    "top5_err": top5,
                    "min_top1_err": self.min_top1_err,
                    "min_top5_err": self.min_top5_err,
                }
            )
        logging.log_json_stats(stats)


class EPICValMeter:
    """(reference meters.py:952-1131)"""

    def __init__(self, max_iter, cfg):
        self.cfg = cfg
        self.max_iter = max_iter
        self.acc = {
            k: ScalarMeter(cfg.LOG_PERIOD)
            for k in ("verb_top1", "verb_top5", "noun_top1", "noun_top5",
                      "action_top1", "action_top5")
        }
        self.totals = {k: 0.0 for k in self.acc}
        self.num_samples = 0
        self.max_top1_acc = {"verb": 0.0, "noun": 0.0, "action": 0.0}

    def reset(self):
        for m in self.acc.values():
            m.reset()
        self.totals = {k: 0.0 for k in self.acc}
        self.num_samples = 0

    def update_stats(self, top1_acc, top5_acc, mb_size):
        for i, k in enumerate(("verb", "noun", "action")):
            self.acc[f"{k}_top1"].add_value(top1_acc[i])
            self.acc[f"{k}_top5"].add_value(top5_acc[i])
            self.totals[f"{k}_top1"] += top1_acc[i] * mb_size
            self.totals[f"{k}_top5"] += top5_acc[i] * mb_size
        self.num_samples += mb_size

    def log_iter_stats(self, cur_epoch, cur_iter):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        logging.log_json_stats(
            {
                "_type": "val_iter",
                "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
                "iter": f"{cur_iter + 1}/{self.max_iter}",
                "verb_top1_acc": self.acc["verb_top1"].get_win_median(),
                "noun_top1_acc": self.acc["noun_top1"].get_win_median(),
                "action_top1_acc": self.acc["action_top1"].get_win_median(),
            }
        )

    def log_epoch_stats(self, cur_epoch):
        n = max(self.num_samples, 1)
        stats = {
            "_type": "val_epoch",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            **{k: v / n for k, v in self.totals.items()},
        }
        is_best = self.totals["action_top1"] / n > self.max_top1_acc["action"]
        for k in ("verb", "noun", "action"):
            self.max_top1_acc[k] = max(
                self.max_top1_acc[k], self.totals[f"{k}_top1"] / n
            )
        logging.log_json_stats(stats)
        return is_best


class EPICTestMeter:
    """Multi-view verb / noun ensemble: per-clip probabilities summed (or
    maxed) into per-video scores; pad rows (clip id -1) and re-delivered
    clips are skipped."""

    def __init__(self, num_videos, num_clips, num_cls, overall_iters,
                 ensemble_method="sum"):
        self.num_clips = num_clips
        self.ensemble_method = ensemble_method
        self.iter_timer = Timer()
        self.verb_preds = np.zeros((num_videos, num_cls[0]), np.float64)
        self.noun_preds = np.zeros((num_videos, num_cls[1]), np.float64)
        self.verb_labels = np.zeros(num_videos, np.int64)
        self.noun_labels = np.zeros(num_videos, np.int64)
        self.clip_count = np.zeros(num_videos, np.int64)
        self.seen_clips = np.zeros(num_videos * num_clips, bool)

    def iter_tic(self):
        self.iter_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()

    def update_stats(self, preds, labels, clip_ids):
        verb, noun = preds
        for i in range(verb.shape[0]):
            cid = int(clip_ids[i])
            if cid < 0 or self.seen_clips[cid]:
                continue
            self.seen_clips[cid] = True
            vid = cid // self.num_clips
            self.verb_labels[vid] = labels["verb"][i]
            self.noun_labels[vid] = labels["noun"][i]
            if self.ensemble_method == "sum":
                self.verb_preds[vid] += verb[i]
                self.noun_preds[vid] += noun[i]
            else:
                self.verb_preds[vid] = np.maximum(self.verb_preds[vid], verb[i])
                self.noun_preds[vid] = np.maximum(self.noun_preds[vid], noun[i])
            self.clip_count[vid] += 1

    def log_iter_stats(self, cur_iter, log_period=10):
        if (cur_iter + 1) % log_period != 0:
            return
        logging.log_json_stats(
            {"split": "test_iter", "cur_iter": cur_iter + 1}
        )

    def finalize_metrics(self, ks=(1, 5)):
        verb_topks = metrics.topk_accuracies(self.verb_preds, self.verb_labels, ks)
        noun_topks = metrics.topk_accuracies(self.noun_preds, self.noun_labels, ks)
        action = metrics.multitask_topk_accuracies(
            (self.verb_preds, self.noun_preds),
            (self.verb_labels, self.noun_labels),
            ks,
        )
        stats = {"split": "test_final"}
        for k, v, n, a in zip(ks, verb_topks, noun_topks, action):
            stats[f"verb_top{k}_acc"] = v
            stats[f"noun_top{k}_acc"] = n
            stats[f"action_top{k}_acc"] = a
        logging.log_json_stats(stats)
        return stats


class TestMeter:
    """Multi-view ensemble meter: sums or maxes per-view probabilities into
    per-video predictions, scored by top-1 / top-5 accuracy, or for
    multi-label data (Charades: multi-hot labels [V, C], the sigmoid head)
    by the mean average precision ``map``."""

    def __init__(
        self,
        num_videos: int,
        num_clips: int,
        num_cls: int,
        overall_iters: int,
        multi_label: bool = False,
        ensemble_method: str = "sum",
    ):
        assert ensemble_method in ["sum", "max"]
        self.num_clips = num_clips
        self.overall_iters = overall_iters
        self.multi_label = multi_label
        self.ensemble_method = ensemble_method
        self.iter_timer = Timer()
        self.video_preds = np.zeros((num_videos, num_cls), np.float64)
        self.video_labels = np.zeros(
            (num_videos, num_cls) if multi_label else (num_videos,), np.int64
        )
        self.clip_count = np.zeros(num_videos, np.int64)
        self.seen_clips = np.zeros(num_videos * num_clips, bool)
        self.stats = {}

    def reset(self):
        self.video_preds[:] = 0
        self.video_labels[:] = 0
        self.clip_count[:] = 0
        self.seen_clips[:] = False

    def iter_tic(self):
        self.iter_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()

    def update_stats(self, preds, labels, clip_ids):
        preds = np.asarray(preds)
        labels = np.asarray(labels)
        clip_ids = np.asarray(clip_ids)
        for i in range(preds.shape[0]):
            # padded duplicates (sentinel -1) and re-delivered clips are
            # skipped so each clip scores exactly once
            cid = int(clip_ids[i])
            if cid < 0 or self.seen_clips[cid]:
                continue
            self.seen_clips[cid] = True
            vid_id = cid // self.num_clips
            if self.clip_count[vid_id] > 0 and not self.multi_label:
                assert self.video_labels[vid_id] == labels[i]
            self.video_labels[vid_id] = labels[i]
            if self.ensemble_method == "sum":
                self.video_preds[vid_id] += preds[i]
            else:
                self.video_preds[vid_id] = np.maximum(
                    self.video_preds[vid_id], preds[i]
                )
            self.clip_count[vid_id] += 1

    def log_iter_stats(self, cur_iter: int, log_period: int = 10):
        if (cur_iter + 1) % log_period != 0:
            return
        logging.log_json_stats(
            {
                "split": "test_iter",
                "cur_iter": f"{cur_iter + 1}",
                "time_diff": self.iter_timer.seconds(),
            }
        )

    def finalize_metrics(self, ks=(1, 5)):
        if not np.all(self.clip_count == self.num_clips):
            mismatch = np.argwhere(self.clip_count != self.num_clips).flatten()
            logger.warning(
                "clip count {} ~= num clips {}".format(
                    ", ".join(f"{i}: {self.clip_count[i]}" for i in mismatch[:10]),
                    self.num_clips,
                )
            )
        stats = {"split": "test_final"}
        if self.multi_label:
            stats["map"] = metrics.mean_ap(self.video_preds, self.video_labels)
        else:
            num_topks = metrics.topks_correct(
                self.video_preds, self.video_labels, ks
            )
            for k, correct in zip(ks, num_topks):
                stats[f"top{k}_acc"] = "{:.2f}".format(
                    correct / self.video_preds.shape[0] * 100.0
                )
        self.stats = stats
        logging.log_json_stats(stats)
        return stats


class AVAMeter:
    """Buffers detection predictions for frame-mAP (reference meters.py:50-232;
    ``focus_tpu/utils/meters.py`` ``AVAMeter``).

    When the official annotation files exist (cfg.AVA.ANNOTATION_DIR +
    EXCLUSION_FILE / LABEL_MAP_FILE / GROUNDTRUTH_FILE), evaluation
    follows the published protocol: GT from the official CSV, excluded
    timestamps dropped, classes restricted to the labelmap whitelist
    (reference meters.py:73-87 + ava_eval_helper.py). Otherwise it falls
    back to scoring against the ground truth buffered from the batches
    (synthetic-data tests)."""

    def __init__(self, overall_iters, cfg, mode, video_idx_to_name=None):
        import os

        from focus_tpu_torch.utils import ava_eval

        self.cfg = cfg
        self.mode = mode
        self.iter_timer = Timer()
        self.all_preds = []
        self.all_ori_boxes = []
        self.all_masks = []
        self.all_keys = []
        self.all_labels = []
        self.full_map = 0.0
        self.full_ava_test = cfg.AVA.FULL_TEST_ON_VAL
        self.video_idx_to_name = video_idx_to_name

        ann = cfg.AVA.ANNOTATION_DIR
        self.excluded_keys = ava_eval.read_exclusions(
            os.path.join(ann, cfg.AVA.EXCLUSION_FILE) if ann else None
        )
        self.categories, self.class_whitelist = ava_eval.read_labelmap(
            os.path.join(ann, cfg.AVA.LABEL_MAP_FILE) if ann else None
        )
        gt_path = os.path.join(ann, cfg.AVA.GROUNDTRUTH_FILE) if ann else ""
        if gt_path and os.path.exists(gt_path):
            self.full_groundtruth = ava_eval.read_csv(
                gt_path, self.class_whitelist or None
            )
            self.mini_groundtruth = ava_eval.get_ava_mini_groundtruth(
                self.full_groundtruth
            )
        else:
            self.full_groundtruth = None
            self.mini_groundtruth = None

    def reset(self):
        self.all_preds.clear()
        self.all_ori_boxes.clear()
        self.all_masks.clear()
        self.all_keys.clear()
        self.all_labels.clear()

    def iter_tic(self):
        self.iter_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()

    def update_stats(self, preds, ori_boxes, masks, video_keys, labels=None):
        self.all_preds.extend(np.asarray(preds))
        self.all_ori_boxes.extend(np.asarray(ori_boxes))
        self.all_masks.extend(np.asarray(masks))
        self.all_keys.extend(list(video_keys))
        if labels is not None:
            self.all_labels.extend(np.asarray(labels))

    def log_iter_stats(self, cur_epoch, cur_iter):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        logging.log_json_stats(
            {
                "_type": f"ava_{self.mode}_iter",
                "cur_iter": cur_iter + 1,
                "time_diff": self.iter_timer.seconds(),
            }
        )

    def finalize_metrics(self):
        from collections import defaultdict

        from focus_tpu_torch.utils import ava_eval

        if self.full_groundtruth is not None:
            # official protocol: GT from csv, exclusions, class whitelist
            det_boxes = defaultdict(list)
            det_labels = defaultdict(list)
            det_scores = defaultdict(list)
            for preds, boxes, mask, key in zip(
                self.all_preds, self.all_ori_boxes, self.all_masks,
                self.all_keys,
            ):
                valid = mask > 0
                for b, p in zip(boxes[valid], preds[valid]):
                    box = [b[1], b[0], b[3], b[2]]  # -> [y1,x1,y2,x2]
                    for cls_idx, score in enumerate(p):
                        if (
                            not self.class_whitelist
                            or (cls_idx + 1) in self.class_whitelist
                        ):
                            det_boxes[key].append(box)
                            det_labels[key].append(cls_idx + 1)
                            det_scores[key].append(float(score))
            gt = (
                self.full_groundtruth
                if (self.mode == "test" or self.full_ava_test)
                else self.mini_groundtruth
            )
            result = ava_eval.run_evaluation(
                self.categories, gt, (det_boxes, det_labels, det_scores),
                self.excluded_keys,
            )
        else:
            groundtruth = []
            for boxes, mask, key, labels in zip(
                self.all_ori_boxes, self.all_masks, self.all_keys,
                self.all_labels,
            ):
                valid = mask > 0
                b = boxes[valid]
                l = labels[valid]
                rows_b, rows_c = [], []
                for bi in range(len(b)):
                    for c in np.nonzero(l[bi])[0]:
                        rows_b.append(b[bi])
                        rows_c.append(c + 1)
                if rows_b:
                    groundtruth.append(
                        (key, np.asarray(rows_b), np.asarray(rows_c))
                    )
            result = ava_eval.run_evaluation_from_buffers(
                self.all_preds, self.all_ori_boxes, self.all_masks,
                self.all_keys, self.cfg.MODEL.NUM_CLASSES,
                groundtruth=groundtruth,
            )
        self.full_map = result["map"]
        logging.log_json_stats(
            {"_type": "ava_final", "mode": self.mode, "map": self.full_map}
        )
        return result
