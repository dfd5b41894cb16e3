"""Normalisation layers (counterpart of ``focus_tpu/models/norms.py``;
reference ``slowfast/models/batchnorm_helper.py``).

BatchNorm has flax's semantics, not ``nn.BatchNorm3d``'s: statistics in
float32 and the result at the input's dtype; in training the batch's mean
and *biased* variance (E[x^2] - E[x]^2, clipped at 0) normalise, and the
running statistics move by flax's momentum 0.9 (torch's 0.1), the variance
biased too (``nn.BatchNorm3d``'s own update takes the unbiased one, so its
forward is not used). Each layer is an ``nn.BatchNorm3d`` for its
parameters and buffers alone, so its state-dict names are the reference's
(``weight``, ``bias``, ``running_mean``, ``running_var``,
``num_batches_tracked``, the last never read or moved).

``batchnorm`` and ``sync_batchnorm`` are one layer, and under data
parallelism (``parallel/mesh.py``) both take the global batch's
statistics: each process's per-channel sums and sums of squares, in
float32, are summed over the processes (differentiably, so the gradient
reaches every process's rows through the global statistics), as XLA
reduces the JAX package's batch-sharded array. The reference's plain
BatchNorm is per GPU; the port follows the JAX package (ROADMAP.md
section 3). ``SubBatchNorm`` is the JAX package's redesign: per-split
statistics in training, and ONE ``[C]`` running buffer updated with the
splits' mixture (not the reference's per-split buffers), so its state is
BatchNorm's. Split j is the samples whose index in the global batch is j
modulo the splits; where the local batch does not divide by the splits, a
process's rows fall in the splits unevenly and each split's statistics
still gather over every process.
"""

import torch
import torch.nn.functional as F
from torch import nn

from focus_tpu_torch.parallel import mesh

BN_MOMENTUM = 0.9  # flax nn.BatchNorm's (torch's momentum 0.1)
BN_EPS = 1e-5


def at_least_float32(x):
    """``x`` in float32, or as it is where it is wider (float64), as flax
    promotes its statistics."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _update_running(bn, mean, var):
    """ra = 0.9 ra + 0.1 stat for the running mean and variance; where
    ``bn.record`` is set (``engine/precise_bn.py``), the batch's statistics
    are added to it instead and the buffers stay."""
    record = getattr(bn, "record", None)
    with torch.no_grad():
        if record is not None:
            record[0] += mean
            record[1] += var
            return
        for ra, stat in ((bn.running_mean, mean), (bn.running_var, var)):
            ra.copy_(BN_MOMENTUM * ra + (1.0 - BN_MOMENTUM) * stat)


def batch_norm(x, bn: nn.modules.batchnorm._BatchNorm, train=False):
    """BatchNorm of ``x`` [N, C, ...] in float32 (float64 stays float64),
    result at x's dtype. Eval: the running statistics. Train, as flax's
    ``nn.BatchNorm``: the batch's
    mean and biased variance over every axis but C (E[x^2] - E[x]^2,
    clipped at 0), and the running statistics updated in place."""
    xf = at_least_float32(x)
    if not train:
        stats = (bn.running_mean, bn.running_var, bn.weight, bn.bias)
        return F.batch_norm(xf, *(t.to(xf.dtype) for t in stats), False,
                            0.0, bn.eps).to(x.dtype)
    dims = (0,) + tuple(range(2, x.ndim))
    sums = mesh.all_reduce_sum(
        torch.stack([xf.sum(dims), (xf * xf).sum(dims)]), mesh.group("data"))
    count = xf.numel() // x.shape[1] * mesh.data_size()
    mean = sums[0] / count
    var = (sums[1] / count - mean * mean).clamp_min(0.0)
    _update_running(bn, mean, var)
    shape = (-1,) + (1,) * (x.ndim - 2)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
    return y.to(x.dtype)


class BatchNorm(nn.BatchNorm3d):
    """flax's BatchNorm over the channels of [N, C, ...] (``batch_norm``).
    ``zero_init``: the scale starts at 0 (``RESNET.ZERO_INIT_FINAL_BN`` on a
    residual transform's last norm; read by ``models/build.py``)."""

    def __init__(self, num_features, zero_init=False):
        super().__init__(num_features, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)
        self.zero_init = zero_init
        self.record = None

    def forward(self, x, train=False):
        return batch_norm(x, self, train)


class SubBatchNorm(BatchNorm):
    """Per-split training statistics (``_SubBNCore``): split j is samples
    j, j + s, ... of the (global) batch; each split is normalised by its
    own mean and biased variance, the JAX layer's two passes (in at least
    float32, then cast), and the one running buffer moves toward the
    splits' mixture. Eval normalises by the running statistics in float32,
    casts, then applies scale and bias at x's dtype, as the JAX layer does
    in both modes."""

    def __init__(self, num_features, num_splits, zero_init=False):
        super().__init__(num_features, zero_init)
        self.num_splits = num_splits

    def forward(self, x, train=False):
        shape = (-1,) + (1,) * (x.ndim - 2)
        if not train:
            xf = (at_least_float32(x) - self.running_mean.view(shape)) / torch.sqrt(
                self.running_var.view(shape) + self.eps)
        else:
            xf = self._split_norm(x)
        return (xf.to(x.dtype) * self.weight.to(x.dtype).view(shape)
                + self.bias.to(x.dtype).view(shape))

    def _split_norm(self, x):
        """The training normalisation: each row's split is its index in
        the global batch (rank x local batch + row) modulo the splits; each
        split's sums, then its centred sums of squares, are summed over the
        processes."""
        B, s = x.shape[0], self.num_splits
        if (B * mesh.data_size()) % s:
            raise ValueError(f"batch {B * mesh.data_size()} does not split "
                             f"into BN.NUM_SPLITS={s}")
        xf = at_least_float32(x)
        split = (mesh.data_rank() * B + torch.arange(B, device=x.device)) % s
        onehot = F.one_hot(split, s).to(xf.dtype)  # [B, s]
        spatial = tuple(range(2, x.ndim))
        per_row = xf.shape[2:].numel()
        count = (B * mesh.data_size() // s) * per_row
        row_shape = (B, -1) + (1,) * (x.ndim - 2)
        mean_s = mesh.all_reduce_sum(onehot.t() @ xf.sum(spatial),
                                     mesh.group("data")) / count
        centred = xf - mean_s[split].view(row_shape)
        var_s = mesh.all_reduce_sum(
            onehot.t() @ (centred * centred).sum(spatial),
            mesh.group("data")) / count
        mean = mean_s.mean(0)
        _update_running(self, mean, var_s.mean(0)
                        + (mean_s ** 2).mean(0) - mean ** 2)
        return centred / torch.sqrt(var_s[split].view(row_shape) + self.eps)


def get_norm(cfg):
    """``norm(num_features, final=False)`` by ``BN.NORM_TYPE``; ``final``
    marks a residual transform's last norm, whose scale starts at 0 under
    ``RESNET.ZERO_INIT_FINAL_BN``."""
    kind = cfg.BN.NORM_TYPE
    zero_final = bool(cfg.RESNET.ZERO_INIT_FINAL_BN)
    if kind in ("batchnorm", "sync_batchnorm"):
        return lambda c, final=False: BatchNorm(c, final and zero_final)
    if kind == "sub_batchnorm":
        return lambda c, final=False: SubBatchNorm(
            c, cfg.BN.NUM_SPLITS, final and zero_final)
    raise NotImplementedError(f"Norm type {kind}")
