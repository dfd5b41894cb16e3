"""Device traces around training steps (counterpart of
``focus_tpu/utils/profiler.py``, on ``torch.profiler``).

With ``TPU.PROFILER: True`` the steps [PROFILER_START_STEP,
PROFILER_START_STEP + PROFILER_NUM_STEPS) of the run are traced (host and,
on the card, CUDA activity) and written as a Chrome trace to
``OUTPUT_DIR/profiler/trace_step{start}.json`` (Perfetto,
``chrome://tracing``).
"""

from __future__ import annotations

import os

import torch

from focus_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


class StepProfiler:
    """Start and stop a ``torch.profiler`` trace over a step window. Call
    ``step(global_step)`` once a training step, before it runs; inactive
    (nothing but a flag check) unless enabled."""

    def __init__(self, cfg):
        tpu = cfg.TPU
        self.enabled = bool(getattr(tpu, "PROFILER", False))
        self.start_step = int(getattr(tpu, "PROFILER_START_STEP", 10))
        self.num_steps = int(getattr(tpu, "PROFILER_NUM_STEPS", 5))
        self.log_dir = os.path.join(cfg.OUTPUT_DIR, "profiler")
        self.trace_path = os.path.join(self.log_dir,
                                       f"trace_step{self.start_step}.json")
        self._prof = None

    def step(self, global_step: int) -> None:
        if not self.enabled:
            return
        if self._prof is None and global_step == self.start_step:
            os.makedirs(self.log_dir, exist_ok=True)
            logger.info(f"profiler: starting trace -> {self.trace_path}")
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
        elif (self._prof is not None
              and global_step >= self.start_step + self.num_steps):
            self.stop()

    def stop(self) -> None:
        if self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            self._prof.export_chrome_trace(self.trace_path)
            self._prof = None
            logger.info(f"profiler: trace written to {self.trace_path}")
