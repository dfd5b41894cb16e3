"""Train-loop helpers (counterpart of ``focus_tpu/utils/misc.py``): which
epochs validate, and the class count of a dataset.

``LOG_MODEL_INFO`` is not ported: the JAX package counts FLOPs through
XLA's cost analysis of the compiled forward, which has no counterpart here;
the trainer raises on it.
"""

from __future__ import annotations


def is_eval_epoch(cfg, cur_epoch, multigrid_schedule=None) -> bool:
    """Whether to validate after ``cur_epoch``: the last epoch, each
    TRAIN.EVAL_PERIOD-th, or under a multigrid schedule MULTIGRID.EVAL_FREQ
    times a stage (reference misc.py:230-253)."""
    if cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH:
        return True
    if multigrid_schedule is not None:
        prev_epoch = 0
        for s in multigrid_schedule:
            if cur_epoch < s[-1]:
                period = max(
                    (s[-1] - prev_epoch) // cfg.MULTIGRID.EVAL_FREQ + 1, 1
                )
                return (s[-1] - 1 - cur_epoch) % period == 0
            prev_epoch = s[-1]
    return (cur_epoch + 1) % cfg.TRAIN.EVAL_PERIOD == 0


def get_num_classes(cfg):
    """EPIC-Kitchens' verb and noun counts, else MODEL.NUM_CLASSES
    (reference misc.py:417-424)."""
    if cfg.TRAIN.DATASET == "epickitchens":
        return {"verb": 97, "noun": 300}
    return cfg.MODEL.NUM_CLASSES
