"""Classification and detection heads of the ResNet family (counterpart of
``focus_tpu/models/heads.py``; reference ``slowfast/models/head_helper.py``).

Feature volumes are NCDHW. The projection runs at the features' dtype over
float32 master weights (flax ``nn.Dense`` at the compute dtype), from
N(0, 0.01^2) with a zero bias. In training a head returns float32 logits
(the loss is taken in float32; a float64 model keeps float64); in eval the
probabilities of ``MODEL.HEAD_ACT``, computed so and averaged over the
positions of the pooled volume, so a test crop larger than the train crop
is scored fully convolutionally as the JAX heads score it (softmax, then
the mean).
"""

import torch
import torch.nn.functional as F
from torch import nn

from focus_tpu_torch.models.common import dropout, linear
from focus_tpu_torch.models.norms import BatchNorm, at_least_float32
from focus_tpu_torch.models.resnet_helper import conv, dense_conv
from focus_tpu_torch.ops.roi_align import roi_align


def projection(dim_in, num_classes):
    layer = nn.Linear(dim_in, num_classes)
    layer.init = ("fc", 1.0)
    return layer


def activation(x, name: str):
    if name == "softmax":
        return torch.softmax(x, dim=-1)
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name == "none":
        return x
    raise NotImplementedError(name)


def _avg_pool(x, pool_size):
    """Mean over windows of ``pool_size`` at stride 1, VALID (the JAX
    heads' ``reduce_window``), summed in at least float32; the global mean
    where it is None."""
    if pool_size is None:
        return x.mean(dim=(2, 3, 4), keepdim=True)
    return F.avg_pool3d(at_least_float32(x), tuple(pool_size),
                        stride=1).to(x.dtype)


def _classify(x, layer, act_func, dropout_rate, train, generator):
    """[B, C, t, h, w] features -> the projection at each position;
    float32 logits [B, t*h*w*K] in training, else the activation's mean
    over the positions [B, K]."""
    x = x.permute(0, 2, 3, 4, 1)
    x = dropout(x, dropout_rate, train, generator)
    x = at_least_float32(linear(x, layer))
    if not train:
        x = activation(x, act_func).mean(dim=(1, 2, 3))
    return x.reshape(x.shape[0], -1)


class ResNetBasicHead(nn.Module):
    """Average pool of each pathway at ``pool_size`` (None: global), the
    pathways concatenated, dropout, the projection (reference
    head_helper.py:133-220)."""

    def __init__(self, dim_in, num_classes, pool_size, dropout_rate=0.0,
                 act_func="softmax"):
        super().__init__()
        self.pool_size = list(pool_size)
        self.dropout_rate, self.act_func = dropout_rate, act_func
        self.projection = projection(sum(dim_in), num_classes)

    def forward(self, inputs, train=False, generator=None):
        x = torch.cat([_avg_pool(v, ps) for v, ps in zip(inputs,
                                                         self.pool_size)], 1)
        return _classify(x, self.projection, self.act_func,
                         self.dropout_rate, train, generator)


class X3DHead(nn.Module):
    """1x1x1 conv, BN, ReLU, average pool, 1x1x1 conv (+BN), ReLU, dropout,
    the projection (reference head_helper.py:223-361). Its BatchNorms are
    plain ones whatever ``BN.NORM_TYPE`` says, as in the JAX head."""

    def __init__(self, dim_in, dim_inner, dim_out, num_classes, pool_size,
                 dropout_rate=0.0, act_func="softmax", bn_lin5_on=False):
        super().__init__()
        self.pool_size = pool_size
        self.dropout_rate, self.act_func = dropout_rate, act_func
        self.conv_5 = dense_conv(dim_in, dim_inner, bias=False)
        self.conv_5_bn = BatchNorm(dim_inner)
        self.lin_5 = dense_conv(dim_inner, dim_out, bias=False)
        if bn_lin5_on:
            self.lin_5_bn = BatchNorm(dim_out)
        self.projection = projection(dim_out, num_classes)

    def forward(self, inputs, train=False, generator=None):
        x = F.relu(self.conv_5_bn(conv(inputs[0], self.conv_5), train))
        x = conv(_avg_pool(x, self.pool_size), self.lin_5)
        if hasattr(self, "lin_5_bn"):
            x = self.lin_5_bn(x, train)
        return _classify(F.relu(x), self.projection, self.act_func,
                         self.dropout_rate, train, generator)


class ResNetRoIHead(nn.Module):
    """Detection head (reference head_helper.py:11-130): each pathway's
    volume averaged over time, RoIAlign (adaptive sampling; ``aligned``
    False is the Caffe2 form, ``DETECTION.ALIGNED``) of the boxes
    ``[B, O, 4]`` (xyxy, input pixels), a spatial max, the pathways
    concatenated, dropout, the projection and the activation: ``[B, O, K]``.
    Training and eval differ only in dropout."""

    def __init__(self, dim_in, num_classes, resolution, scale_factor,
                 dropout_rate=0.0, act_func="softmax", aligned=True):
        super().__init__()
        self.aligned = bool(aligned)
        self.resolution = [tuple(r) for r in resolution]
        self.scale_factor = list(scale_factor)
        self.dropout_rate, self.act_func = dropout_rate, act_func
        self.projection = projection(sum(dim_in), num_classes)

    def forward(self, inputs, bboxes, train=False, generator=None):
        pooled = []
        for p, volume in enumerate(inputs):
            feat = volume.mean(dim=2).permute(0, 2, 3, 1)  # [B, H, W, C]
            out = roi_align(feat, bboxes, self.resolution[p],
                            1.0 / self.scale_factor[p], self.aligned)
            pooled.append(out.amax(dim=(2, 3)))  # [B, O, C]
        x = dropout(torch.cat(pooled, dim=-1), self.dropout_rate, train,
                    generator)
        return activation(at_least_float32(linear(x, self.projection)),
                          self.act_func)
