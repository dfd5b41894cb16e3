"""Rank-zero-gated logging and json stat lines (counterpart of
``focus_tpu/utils/logging.py``).

``setup_logging(output_dir)`` installs a stdout + file handler on rank 0
and silences the other ranks; ``close_logging()`` closes and removes them;
``log_json_stats(stats)`` emits one compact
json line per call. The rank is ``torch.distributed``'s where a process
group is initialised, else 0.
"""

from __future__ import annotations

import builtins
import decimal
import functools
import json
import logging
import os
import sys

import torch.distributed as dist

ROOT = "focus_tpu_torch"


def rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_master_process() -> bool:
    return rank() == 0


@functools.lru_cache(maxsize=None)
def _suppress_print() -> None:
    def print_none(*objects, sep=" ", end="\n", file=sys.stdout, flush=False):
        pass

    builtins.print = print_none


@functools.lru_cache(maxsize=None)
def setup_logging(output_dir: str | None = None) -> None:
    """Configure the package's root logger. Call once per process."""
    logger = logging.getLogger(ROOT)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    _close_handlers(logger)
    fmt = logging.Formatter(
        "[%(asctime)s][%(levelname)s] %(filename)s: %(lineno)3d: %(message)s",
        datefmt="%m/%d %H:%M:%S",
    )
    if is_master_process():
        sh = logging.StreamHandler(sys.stdout)
        sh.setLevel(logging.DEBUG)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(output_dir, "stdout.log"))
            fh.setLevel(logging.DEBUG)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    else:
        _suppress_print()
        logger.addHandler(logging.NullHandler())


def _close_handlers(logger: logging.Logger) -> None:
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()


def close_logging() -> None:
    """Close and remove the handlers of ``setup_logging``; its next call
    installs them anew."""
    _close_handlers(logging.getLogger(ROOT))
    setup_logging.cache_clear()


def get_logger(name: str) -> logging.Logger:
    if not name.startswith(ROOT):
        name = ROOT + "." + name
    return logging.getLogger(name)


class _StatEncoder(json.JSONEncoder):
    def default(self, o):
        try:
            return float(o)
        except (TypeError, ValueError):
            return str(o)


def log_json_stats(stats: dict) -> None:
    """Log one json line of statistics."""
    stats = {
        k: decimal.Decimal(f"{v:.5f}") if isinstance(v, float) else v
        for k, v in stats.items()
    }
    logger = get_logger(__name__)
    logger.info("json_stats: {:s}".format(
        json.dumps(stats, cls=_StatEncoder, sort_keys=True)))
