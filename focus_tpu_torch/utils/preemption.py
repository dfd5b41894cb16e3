"""Preemption-aware checkpointing (a copy of
``focus_tpu/utils/preemption.py``).

Spot capacity, defragmentation and maintenance end a job with a SIGTERM
and a grace window. The handler here only sets a flag; the train loop
polls it every ``TPU.PREEMPT_SYNC_PERIOD`` steps and, once set, saves a
checkpoint of the in-progress epoch and exits with status 0 so that the
scheduler requeues the job. ``TRAIN.AUTO_RESUME`` then replays the
interrupted epoch: the reference's epoch-granularity resume, minus the
lost work.

The saved ``epoch`` is the in-progress epoch (the completed-epoch count),
as the end-of-epoch save writes ``cur_epoch + 1``. The state's ``step``
and generator carry the mid-epoch position, so the step-driven LR
schedule continues exactly; the replayed epoch's data order is drawn again
from the epoch seed.

Under data parallelism every process polls at the same iterations, and
there the processes agree on the flag (an all-reduce max, as the JAX
package's all-gather of the hosts' flags): a signal to any one stops all
of them at the same iteration, and rank 0 writes the one checkpoint.
"""

from __future__ import annotations

import signal
import threading

from focus_tpu_torch.parallel import mesh
from focus_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

_FLAG = threading.Event()
_INSTALLED = False


def request_preemption() -> None:
    """Mark this process as preempted (the signal handler, or a test)."""
    _FLAG.set()


def preemption_requested() -> bool:
    return _FLAG.is_set()


def clear_preemption() -> None:
    """Reset the flag (tests; between independent runs)."""
    _FLAG.clear()


def _handler(signum, frame):
    logger.info(
        f"Received signal {signum}: checkpoint-and-exit at the next "
        "preemption sync point"
    )
    _FLAG.set()


def install_signal_handlers(signals=(signal.SIGTERM,)) -> bool:
    """Install flag-setting handlers (idempotent). Returns False when not
    on the main thread, where CPython forbids signal.signal; the guard then
    still works through :func:`request_preemption`."""
    global _INSTALLED
    if _INSTALLED:
        return True
    try:
        for s in signals:
            signal.signal(s, _handler)
    except ValueError:  # not the main thread
        return False
    _INSTALLED = True
    return True


class PreemptionSignaled(Exception):
    """Raised out of a train epoch at a preemption sync point. Carries the
    in-progress epoch and the train state."""

    def __init__(self, epoch: int, state):
        super().__init__(f"preempted during epoch {epoch}")
        self.epoch = epoch
        self.state = state


class PreemptionGuard:
    """Polls the preemption flag every ``TPU.PREEMPT_SYNC_PERIOD``
    iterations (``TPU.PREEMPTION_SAVE`` turns it on); ``poll(cur_iter)`` is
    a host-side modulo off the period and, on it, the flag agreed over the
    processes (every process calls it at the same iterations)."""

    def __init__(self, cfg):
        self.enabled = bool(getattr(cfg.TPU, "PREEMPTION_SAVE", True))
        self.period = max(
            int(getattr(cfg.TPU, "PREEMPT_SYNC_PERIOD", 10) or 10), 1
        )
        if self.enabled:
            install_signal_handlers()

    def poll(self, cur_iter: int) -> bool:
        if not self.enabled or (cur_iter + 1) % self.period:
            return False
        return mesh.any_process(preemption_requested())
