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

One process drives one device, so ``sync_batchnorm`` is ``batchnorm``.
``SubBatchNorm`` is the JAX package's redesign: per-split statistics in
training, and ONE ``[C]`` running buffer updated with the splits' mixture
(not the reference's per-split buffers), so its state is BatchNorm's.
"""

import torch
import torch.nn.functional as F
from torch import nn

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
    mean = xf.mean(dims)
    var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0.0)
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
    j, j + s, ... of the batch; each split is normalised by its own mean
    and biased variance (in at least float32, then cast), and the one running buffer
    moves toward the splits' mixture. Eval normalises by the running
    statistics in float32, casts, then applies scale and bias at x's dtype,
    as the JAX layer does in both modes."""

    def __init__(self, num_features, num_splits, zero_init=False):
        super().__init__(num_features, zero_init)
        self.num_splits = num_splits

    def forward(self, x, train=False):
        shape = (-1,) + (1,) * (x.ndim - 2)
        if not train:
            xf = (at_least_float32(x) - self.running_mean.view(shape)) / torch.sqrt(
                self.running_var.view(shape) + self.eps)
        else:
            B, s = x.shape[0], self.num_splits
            if B % s:
                raise ValueError(f"batch {B} does not split into "
                                 f"BN.NUM_SPLITS={s}")
            xs = at_least_float32(x).reshape((B // s, s) + x.shape[1:])
            dims = (0,) + tuple(range(3, xs.ndim))
            split_shape = (1, s, -1) + (1,) * (x.ndim - 2)
            mean_s = xs.mean(dims)  # [s, C]
            centred = xs - mean_s.view(split_shape)
            var_s = (centred ** 2).mean(dims)
            xf = (centred / torch.sqrt(var_s.view(split_shape) + self.eps)
                  ).reshape(x.shape)
            mean = mean_s.mean(0)
            _update_running(self, mean, var_s.mean(0)
                            + (mean_s ** 2).mean(0) - mean ** 2)
        return (xf.to(x.dtype) * self.weight.to(x.dtype).view(shape)
                + self.bias.to(x.dtype).view(shape))


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
