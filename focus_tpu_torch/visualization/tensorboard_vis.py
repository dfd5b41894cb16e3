"""TensorBoard scalars of the train loop (counterpart of
``TensorboardWriter`` in ``focus_tpu/visualization/tensorboard_vis.py``:
``add_scalars``, ``plot_eval``, ``close``).

Gated as the JAX writer is: where ``TENSORBOARD.ENABLE`` is off, or
``torch.utils.tensorboard`` does not import (it needs the ``tensorboard``
package), the writer does nothing; the second case is logged once. The
eval panels (``TENSORBOARD.CONFUSION_MATRIX``, ``HISTOGRAM``) are not
ported: asking for one raises.
"""

from __future__ import annotations

import functools
import os

from focus_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


@functools.lru_cache(maxsize=None)
def _summary_writer_class():
    """``SummaryWriter``, or None (logged once) where it does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception as e:  # noqa: BLE001 (tensorboard missing or broken)
        logger.info(f"TensorBoard scalars are off: {e}")
        return None
    return SummaryWriter


def check_panels(cfg) -> None:
    """Raise where the config asks for an eval panel."""
    tb = cfg.TENSORBOARD
    if tb.ENABLE and (tb.CONFUSION_MATRIX.ENABLE or tb.HISTOGRAM.ENABLE):
        raise NotImplementedError(
            "TENSORBOARD.CONFUSION_MATRIX / HISTOGRAM: the eval panels come "
            "with the visualization slice of the port"
        )


class TensorboardWriter:
    def __init__(self, cfg):
        check_panels(cfg)
        self.cfg = cfg
        writer_cls = (_summary_writer_class() if cfg.TENSORBOARD.ENABLE
                      else None)
        self.enabled = writer_cls is not None
        if not self.enabled:
            self.writer = None
            return
        if cfg.TENSORBOARD.LOG_DIR == "":
            log_dir = os.path.join(
                cfg.OUTPUT_DIR, "runs-{}".format(cfg.TRAIN.DATASET)
            )
        else:
            log_dir = os.path.join(cfg.OUTPUT_DIR, cfg.TENSORBOARD.LOG_DIR)
        self.writer = writer_cls(log_dir=log_dir)
        logger.info(f"Tensorboard visualization at {log_dir}")

    def add_scalars(self, data_dict, global_step=None):
        if self.writer is None:
            return
        for key, item in data_dict.items():
            self.writer.add_scalar(key, float(item), global_step)

    def plot_eval(self, preds, labels, global_step=None):
        """The eval panels: nothing where none is asked for (the only case
        the constructor lets through)."""
        if self.writer is None or self.cfg.DETECTION.ENABLE:
            return
        check_panels(self.cfg)

    def close(self):
        if self.writer is not None:
            self.writer.flush()
            self.writer.close()
