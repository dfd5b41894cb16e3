"""Precise BN: the BatchNorm running statistics recomputed over training
batches (counterpart of ``focus_tpu/engine/precise_bn.py``; fvcore's
``update_bn_stats``, reference ``tools/train_net.py:716-728``).

Each batch's own statistics (the mean and biased variance its train-mode
forward normalises with) are averaged with equal weight over up to
``num_batches`` batches and replace every BatchNorm's running buffers. The
JAX function recovers them from flax's momentum update, (new - 0.9 old) /
0.1; here each layer adds them up directly (``models/norms.py``'s
``record``). Dropout and stochastic depth, which come after or beside the
norms and move no statistic, draw from a generator seeded with 0, as the
JAX forward passes ``PRNGKey(0)``. A uint8 batch is normalised first, as
the train step normalises it (the JAX function hands the loader's batch to
the model as it comes). Under data parallelism each batch is the global
batch: the train-mode norms take its statistics over the processes
(``models/norms.py``), and the draws are the global batch's, sliced
(``models/common.sharded_draws``), so every process records the same
averages.
"""

from __future__ import annotations

import torch

from focus_tpu_torch.models.common import sharded_draws
from focus_tpu_torch.models.norms import BatchNorm
from focus_tpu_torch.ops.preprocess import device_normalize
from focus_tpu_torch.parallel import mesh
from focus_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


@torch.no_grad()
def compute_precise_bn_stats(model, loader, num_batches: int, split_batch_fn,
                             cfg) -> int:
    """Replace ``model``'s BatchNorm running statistics by their precise
    averages over the first ``num_batches`` batches of ``loader``; returns
    the batches used (0 leaves the statistics as they were)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    if not norms or num_batches <= 0:
        return 0
    device = norms[0].running_mean.device
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    for bn in norms:
        bn.record = [torch.zeros_like(bn.running_mean),
                     torch.zeros_like(bn.running_var)]
    count = 0
    try:
        for i, batch in enumerate(loader):
            if i >= num_batches:
                break
            video, _, metadata = split_batch_fn(batch)
            first = video[0] if isinstance(video, (tuple, list)) else video
            with sharded_draws(*mesh.batch_rows(first.shape[0])):
                model(device_normalize(video, cfg), metadata, train=True,
                      generator=generator)
            count += 1
        if count:
            for bn in norms:
                bn.running_mean.copy_(bn.record[0] / count)
                bn.running_var.copy_(bn.record[1] / count)
    finally:
        for bn in norms:
            bn.record = None
    logger.info(f"Precise BN stats computed over {count} batches")
    return count
