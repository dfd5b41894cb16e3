"""Test meters (counterpart of ``focus_tpu/utils/meters.py``): the timer
and the multi-view ensembles of the test path, ``TestMeter`` and
``EPICTestMeter``. The windowed scalar and the train, val and AVA meters
come with the train loop and the detection path.

Timing is wall-clock on the host.
"""

from __future__ import annotations

import time

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
    """Multi-view ensemble meter: sums or maxes per-view softmax scores
    into per-video predictions. Multi-label data (mean average precision,
    Charades) is not ported yet and raises."""

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
        if multi_label:
            raise NotImplementedError(
                "DATA.MULTI_LABEL: the multi-label test meter (mean average "
                "precision) comes with the Charades slice of the port"
            )
        self.num_clips = num_clips
        self.overall_iters = overall_iters
        self.multi_label = multi_label
        self.ensemble_method = ensemble_method
        self.iter_timer = Timer()
        self.video_preds = np.zeros((num_videos, num_cls), np.float64)
        self.video_labels = np.zeros((num_videos,), np.int64)
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
            if self.clip_count[vid_id] > 0:
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
