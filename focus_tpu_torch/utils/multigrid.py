"""Multigrid training schedule (a copy of ``focus_tpu/utils/multigrid.py``;
reference ``slowfast/utils/multigrid.py``).

``init_multigrid`` rewrites the config before the build (the LR steps and
relative LRs, MAX_EPOCH); ``update_long_cycle`` sets each epoch's (B, T, S)
and its BN type (``sync_batchnorm`` below ``MULTIGRID.BN_BASE_SIZE``
clips a process, ``sub_batchnorm`` with NUM_SPLITS above it); the trainer
rebuilds the model and the loaders at each change
(``engine/trainer._rebuild_for_long_cycle``).
"""

from __future__ import annotations

import numpy as np

from focus_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


class MultigridSchedule:
    def init_multigrid(self, cfg):
        """(reference multigrid.py:19-61)"""
        self.schedule = None
        cfg.MULTIGRID.DEFAULT_B = cfg.TRAIN.BATCH_SIZE
        cfg.MULTIGRID.DEFAULT_T = cfg.DATA.NUM_FRAMES
        cfg.MULTIGRID.DEFAULT_S = cfg.DATA.TRAIN_CROP_SIZE
        if cfg.MULTIGRID.LONG_CYCLE:
            self.schedule = self.get_long_cycle_schedule(cfg)
            cfg.SOLVER.STEPS = [0] + [s[-1] for s in self.schedule]
            cfg.SOLVER.STEPS[-1] = (
                cfg.SOLVER.STEPS[-2] + cfg.SOLVER.STEPS[-1]
            ) // 2
            cfg.SOLVER.LRS = [
                cfg.SOLVER.GAMMA ** s[0] * s[1][0] for s in self.schedule
            ]
            cfg.SOLVER.LRS = cfg.SOLVER.LRS[:-1] + [
                cfg.SOLVER.LRS[-2],
                cfg.SOLVER.LRS[-1],
            ]
            cfg.SOLVER.MAX_EPOCH = self.schedule[-1][-1]
        elif cfg.MULTIGRID.SHORT_CYCLE:
            cfg.SOLVER.STEPS = [
                int(s * cfg.MULTIGRID.EPOCH_FACTOR) for s in cfg.SOLVER.STEPS
            ]
            cfg.SOLVER.MAX_EPOCH = int(
                cfg.SOLVER.MAX_EPOCH * cfg.MULTIGRID.EPOCH_FACTOR
            )
        return cfg

    def update_long_cycle(self, cfg, cur_epoch):
        """(reference multigrid.py:63-121)"""
        base_b, base_t, base_s = get_current_long_cycle_shape(
            self.schedule, cur_epoch
        )
        if base_s == cfg.DATA.TRAIN_CROP_SIZE and base_t == cfg.DATA.NUM_FRAMES:
            return cfg, False
        cfg.DATA.NUM_FRAMES = base_t
        cfg.DATA.TRAIN_CROP_SIZE = base_s
        cfg.TRAIN.BATCH_SIZE = base_b * cfg.MULTIGRID.DEFAULT_B
        bs_factor = (
            float(cfg.TRAIN.BATCH_SIZE / max(cfg.NUM_GPUS, 1))
            / cfg.MULTIGRID.BN_BASE_SIZE
        )
        if bs_factor < 1:
            cfg.BN.NORM_TYPE = "sync_batchnorm"
            cfg.BN.NUM_SYNC_DEVICES = int(1.0 / bs_factor)
        elif bs_factor > 1:
            cfg.BN.NORM_TYPE = "sub_batchnorm"
            cfg.BN.NUM_SPLITS = int(bs_factor)
        else:
            cfg.BN.NORM_TYPE = "batchnorm"
        cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE = cfg.DATA.SAMPLING_RATE * (
            cfg.MULTIGRID.DEFAULT_T // cfg.DATA.NUM_FRAMES
        )
        logger.info(
            f"Long cycle update: B={cfg.TRAIN.BATCH_SIZE} "
            f"T={cfg.DATA.NUM_FRAMES} S={cfg.DATA.TRAIN_CROP_SIZE} "
            f"BN={cfg.BN.NORM_TYPE}"
        )
        return cfg, True

    def get_long_cycle_schedule(self, cfg):
        """(behaviour of reference multigrid.py:123-214; see
        long_cycle_schedule)"""
        return long_cycle_schedule(
            factors=cfg.MULTIGRID.LONG_CYCLE_FACTORS,
            default_t=cfg.DATA.NUM_FRAMES,
            default_s=cfg.DATA.TRAIN_CROP_SIZE,
            lr_steps=list(cfg.SOLVER.STEPS),
            max_epoch=cfg.SOLVER.MAX_EPOCH,
            epoch_factor=cfg.MULTIGRID.EPOCH_FACTOR,
            short_cycle_factors=(
                cfg.MULTIGRID.SHORT_CYCLE_FACTORS
                if cfg.MULTIGRID.SHORT_CYCLE else None
            ),
        )


def long_cycle_schedule(factors, default_t, default_s, lr_steps, max_epoch,
                        epoch_factor, short_cycle_factors=None):
    """Compute the long-cycle shape schedule as a pure function.

    Multigrid training (Wu et al.; reference multigrid.py:123-214)
    cycles through cheaper (T, S) input shapes, raising the batch size
    to keep per-step memory/compute roughly constant, then rescales the
    epoch budget so the *iteration* count shrinks while the *epoch*
    count grows. Per long-cycle factor ``(t_f, s_f)``:

      t_k = round(default_t * t_f), s_k = round(default_s * s_f)
      batch factor b = round(default_t*default_s^2 / (t*s^2)) for each
      of the cycle's shapes (with short cycles, the two short spatial
      sizes share t_k and contribute to the cycle's mean batch factor).

    Within every LR-step interval, each cycle runs for a duration
    proportional to its mean batch factor (equal iteration counts per
    cycle); a fine-tune stage at the final shape covers the post-steps
    epochs scaled by the overall iteration saving; all durations are then
    normalised so the total equals ``max_epoch * epoch_factor``.

    Returns [(lr_step_index, (b, t, s), end_epoch)] with cumulative
    integer end epochs.
    """
    factors = np.asarray(factors, np.float64)  # [K, 2]
    t_k = np.rint(default_t * factors[:, 0]).astype(np.int64)  # [K]
    s_k = np.rint(default_s * factors[:, 1]).astype(np.int64)  # [K]
    full_size = np.float64(default_t) * default_s ** 2

    if short_cycle_factors is not None:
        # spatial sizes per cycle: two short shapes (off the ORIGINAL
        # crop size and left FRACTIONAL — reference quirks, they only
        # feed the batch-factor means) then the long shape — [K, 3]
        short = np.asarray(short_cycle_factors[:2], np.float64) * default_s
        spatial = np.concatenate(
            [np.broadcast_to(short, (len(factors), 2)),
             s_k[:, None].astype(np.float64)], axis=1
        )
    else:
        spatial = s_k[:, None].astype(np.float64)  # [K, 1]
    b_kj = np.rint(full_size / (t_k[:, None] * spatial ** 2))  # [K, n_shapes]
    mean_b = b_kj.mean(axis=1)  # [K]
    long_b = b_kj[:, -1].astype(np.int64)  # batch factor at the long shape

    # interval lengths between LR steps; each interval is split across
    # the K cycles proportional to mean_b (equal iterations per cycle)
    lr_steps = np.asarray(lr_steps, np.float64)
    intervals = np.diff(lr_steps)  # [n_steps-1]
    dur = intervals[:, None] * (mean_b / mean_b.sum())  # [n_steps-1, K]
    # iteration saving of the cycled stages vs running at full shape
    rel_iters = (dur / mean_b).sum()
    saving = lr_steps[-1] / rel_iters
    # fine-tune stage: remaining epochs at the last shape, stretched by
    # the batch factor but shrunk by the overall saving
    ft = (max_epoch - lr_steps[-1]) / saving * mean_b[-1]

    durations = np.append(dur.reshape(-1), ft)
    durations *= max_epoch * epoch_factor / durations.sum()
    ends = np.rint(np.cumsum(durations)).astype(np.int64)

    lr_idx = np.append(
        np.repeat(np.arange(len(intervals)), len(factors)), len(intervals)
    )
    shapes = [
        (int(long_b[k]), int(t_k[k]), int(s_k[k]))
        for _ in range(len(intervals))
        for k in range(len(factors))
    ] + [(int(long_b[-1]), int(t_k[-1]), int(s_k[-1]))]

    schedule = [
        (int(i), list(shape), int(e))
        for i, shape, e in zip(lr_idx, shapes, ends)
    ]
    for s in schedule:
        logger.info(f"long-cycle {s[0]}\tshape {s[1]}\tuntil epoch {s[2]}")
    return schedule


def get_current_long_cycle_shape(schedule, epoch):
    for s in schedule:
        if epoch < s[-1]:
            return s[1]
    return schedule[-1][1]
