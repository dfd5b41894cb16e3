"""3D-ResNet machinery: stems, residual transforms, stages, non-local
(counterpart of ``focus_tpu/models/resnet_helper.py``; reference
``slowfast/models/{resnet_helper,stem_helper,nonlocal_helper,operators}.py``).

Every module here takes and returns NCDHW volumes ``[B, C, T, H, W]`` (the
JAX package's are channels-last). Convolutions run at the input's dtype
over float32 master weights (``conv3d``: ``F.conv3d``, cuDNN on the card);
BatchNorm is ``models/norms.py``'s. Module and parameter names are the
reference's torch names, so its ``.pyth`` state dicts load by name. Each
convolution carries the name of its JAX initialiser in ``.init``:
``kaiming_fan_out`` (``variance_scaling(2.0, "fan_out", "normal")``) for
the ResNet convolutions, ``lecun`` (flax ``nn.Conv``'s default) for the SE
and non-local ones, which have a bias.
"""

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from focus_tpu_torch.models.motionformer import drop_path
from focus_tpu_torch.models.norms import at_least_float32


def conv3d(dim_in, dim_out, kernel, stride=(1, 1, 1), padding=(0, 0, 0),
           groups=1, dilation=(1, 1, 1)):
    """A bias-free ``nn.Conv3d`` tagged with the kaiming fan-out normal
    initialiser."""
    layer = nn.Conv3d(dim_in, dim_out, tuple(kernel), tuple(stride),
                      tuple(padding), tuple(dilation), groups, bias=False)
    layer.init = ("kaiming_fan_out", 1.0)
    return layer


def dense_conv(dim_in, dim_out, bias=True):
    """A 1x1x1 ``nn.Conv3d`` with flax ``nn.Conv``'s default initialiser
    (lecun normal, zero bias)."""
    layer = nn.Conv3d(dim_in, dim_out, 1, bias=bias)
    layer.init = ("lecun", 1.0)
    return layer


def conv(x, layer: nn.Conv3d):
    """``layer`` applied to NCDHW ``x`` at x's dtype."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.conv3d(x, layer.weight.to(x.dtype), bias, layer.stride,
                    layer.padding, layer.dilation, layer.groups)


def max_pool3d(x, kernel, stride, padding=(0, 0, 0)):
    """Max pool with -inf padding (``jax.lax.reduce_window`` with max)."""
    return F.max_pool3d(x, tuple(kernel), tuple(stride), tuple(padding))


def swish(x):
    return x * torch.sigmoid(x)


class SE(nn.Module):
    """Squeeze-excitation (reference operators.py:42-73), its width rounded
    as the reference rounds it: at least 8, a multiple of 8, 8 more where
    the rounding lost over 10%."""

    def __init__(self, dim_in, ratio):
        super().__init__()
        dim_fc = max(8, int(dim_in * ratio + 4) // 8 * 8)
        if dim_fc < 0.9 * dim_in * ratio:
            dim_fc += 8
        self.fc1 = dense_conv(dim_in, dim_fc)
        self.fc2 = dense_conv(dim_fc, dim_in)

    def forward(self, x):
        s = x.mean(dim=(2, 3, 4), keepdim=True)
        s = conv(F.relu(conv(s, self.fc1)), self.fc2)
        return x * torch.sigmoid(s)


class ResNetBasicStem(nn.Module):
    """conv -> BN -> ReLU -> 1x3x3 / 1x2x2 max pool (reference
    stem_helper.py:125-201)."""

    def __init__(self, dim_in, dim_out, kernel, stride, padding, norm):
        super().__init__()
        self.conv = conv3d(dim_in, dim_out, kernel, stride, padding)
        self.bn = norm(dim_out)

    def forward(self, x, train=False):
        x = F.relu(self.bn(conv(x, self.conv), train))
        return max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))


class X3DStem(nn.Module):
    """A spatial conv, then a depthwise temporal conv, BN, ReLU (reference
    stem_helper.py:204-289)."""

    def __init__(self, dim_in, dim_out, kernel, stride, padding, norm):
        super().__init__()
        self.conv_xy = conv3d(dim_in, dim_out, (1, kernel[1], kernel[2]),
                              (1, stride[1], stride[2]),
                              (0, padding[1], padding[2]))
        self.conv = conv3d(dim_out, dim_out, (kernel[0], 1, 1),
                           (stride[0], 1, 1), (padding[0], 0, 0),
                           groups=dim_out)
        self.bn = norm(dim_out)

    def forward(self, x, train=False):
        x = conv(conv(x, self.conv_xy), self.conv)
        return F.relu(self.bn(x, train))


_STEMS = {"basic_stem": ResNetBasicStem, "x3d_stem": X3DStem}


class VideoModelStem(nn.Module):
    """One stem a pathway, ``pathway{p}_stem`` (reference
    stem_helper.py:20-122)."""

    def __init__(self, dim_in, dim_out, kernel, stride, padding, norm,
                 stem_func_name="basic_stem"):
        super().__init__()
        for p in range(len(dim_in)):
            self.add_module(f"pathway{p}_stem", _STEMS[stem_func_name](
                dim_in[p], dim_out[p], kernel[p], stride[p], padding[p],
                norm))

    def forward(self, xs, train=False):
        return [getattr(self, f"pathway{p}_stem")(x, train)
                for p, x in enumerate(xs)]


class BasicTransform(nn.Module):
    """Tx3x3 -> 1x3x3 (reference resnet_helper.py:29-113)."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, dim_inner,
                 num_groups, norm, stride_1x1=False, dilation=1, block_idx=0):
        super().__init__()
        k = temp_kernel_size
        self.a = conv3d(dim_in, dim_out, (k, 3, 3), (1, stride, stride),
                        (k // 2, 1, 1))
        self.a_bn = norm(dim_out)
        self.b = conv3d(dim_out, dim_out, (1, 3, 3), (1, 1, 1), (0, 1, 1))
        self.b_bn = norm(dim_out, final=True)

    def forward(self, x, train=False):
        x = F.relu(self.a_bn(conv(x, self.a), train))
        return self.b_bn(conv(x, self.b), train)


class BottleneckTransform(nn.Module):
    """Tx1x1 -> 1x3x3 (grouped, dilated) -> 1x1x1 (reference
    resnet_helper.py:256-381); the stride on the first conv under
    ``STRIDE_1X1``, else on the second."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, dim_inner,
                 num_groups, norm, stride_1x1=False, dilation=1, block_idx=0):
        super().__init__()
        str1, str3 = (stride, 1) if stride_1x1 else (1, stride)
        k, d = temp_kernel_size, dilation
        self.a = conv3d(dim_in, dim_inner, (k, 1, 1), (1, str1, str1),
                        (k // 2, 0, 0))
        self.a_bn = norm(dim_inner)
        self.b = conv3d(dim_inner, dim_inner, (1, 3, 3), (1, str3, str3),
                        (0, d, d), groups=num_groups, dilation=(1, d, d))
        self.b_bn = norm(dim_inner)
        self.c = conv3d(dim_inner, dim_out, (1, 1, 1))
        self.c_bn = norm(dim_out, final=True)

    def forward(self, x, train=False):
        x = F.relu(self.a_bn(conv(x, self.a), train))
        x = F.relu(self.b_bn(conv(x, self.b), train))
        return self.c_bn(conv(x, self.c), train)


class X3DTransform(nn.Module):
    """1x1x1 -> Tx3x3 depthwise (+SE on every other block, swish) -> 1x1x1
    (reference resnet_helper.py:116-253)."""

    se_ratio = 0.0625

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, dim_inner,
                 num_groups, norm, stride_1x1=False, dilation=1, block_idx=0):
        super().__init__()
        str1, str3 = (stride, 1) if stride_1x1 else (1, stride)
        k, d = temp_kernel_size, dilation
        self.a = conv3d(dim_in, dim_inner, (1, 1, 1), (1, str1, str1))
        self.a_bn = norm(dim_inner)
        self.b = conv3d(dim_inner, dim_inner, (k, 3, 3), (1, str3, str3),
                        (k // 2, d, d), groups=num_groups, dilation=(1, d, d))
        self.b_bn = norm(dim_inner)
        if (block_idx + 1) % 2:
            self.se = SE(dim_inner, self.se_ratio)
        self.c = conv3d(dim_inner, dim_out, (1, 1, 1))
        self.c_bn = norm(dim_out, final=True)

    def forward(self, x, train=False):
        x = F.relu(self.a_bn(conv(x, self.a), train))
        x = self.b_bn(conv(x, self.b), train)
        if hasattr(self, "se"):
            x = self.se(x)
        return self.c_bn(conv(swish(x), self.c), train)


_TRANS = {
    "basic_transform": BasicTransform,
    "bottleneck_transform": BottleneckTransform,
    "x3d_transform": X3DTransform,
}


class ResBlock(nn.Module):
    """relu(shortcut + transform) (reference resnet_helper.py:384-517): the
    shortcut a strided 1x1x1 conv and BN where the width or stride
    changes; stochastic depth on the transform in training at
    ``drop_connect_rate``."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride,
                 trans_func_name, dim_inner, num_groups, norm,
                 stride_1x1=False, dilation=1, block_idx=0,
                 drop_connect_rate=0.0):
        super().__init__()
        self.drop_connect_rate = drop_connect_rate
        self.branch2 = _TRANS[trans_func_name](
            dim_in, dim_out, temp_kernel_size, stride, dim_inner, num_groups,
            norm, stride_1x1, dilation, block_idx)
        if dim_in != dim_out or stride != 1:
            self.branch1 = conv3d(dim_in, dim_out, (1, 1, 1),
                                  (1, stride, stride))
            self.branch1_bn = norm(dim_out)

    def forward(self, x, train=False, generator=None):
        f_x = self.branch2(x, train)
        if train and self.drop_connect_rate > 0.0:
            f_x = drop_path(f_x, self.drop_connect_rate, generator)
        if hasattr(self, "branch1"):
            x = self.branch1_bn(conv(x, self.branch1), train)
        return F.relu(x + f_x)


class Nonlocal(nn.Module):
    """Non-local block (reference nonlocal_helper.py:10-148): theta over
    every position, phi and g over the max-pooled ones, the affinity and
    its product with g in float32 over the operands at the compute dtype
    (the JAX einsums' ``preferred_element_type``), ``softmax`` (scaled by
    dim_inner^-1/2) or ``dot_product`` (divided by the pooled count)."""

    def __init__(self, dim, dim_inner, pool_size, instantiation, norm):
        super().__init__()
        if instantiation not in ("softmax", "dot_product"):
            raise NotImplementedError(instantiation)
        self.dim_inner = dim_inner
        self.pool_size = tuple(pool_size) if pool_size is not None else None
        self.instantiation = instantiation
        self.conv_theta = dense_conv(dim, dim_inner)
        self.conv_phi = dense_conv(dim, dim_inner)
        self.conv_g = dense_conv(dim, dim_inner)
        self.conv_out = dense_conv(dim_inner, dim)
        self.bn = norm(dim)

    def forward(self, x, train=False):
        B, C, T, H, W = x.shape
        theta = conv(x, self.conv_theta)
        xp = x
        if self.pool_size is not None and math.prod(self.pool_size) > 1:
            xp = max_pool3d(x, self.pool_size, self.pool_size)
        phi, g = conv(xp, self.conv_phi), conv(xp, self.conv_g)
        th = at_least_float32(theta.flatten(2).transpose(1, 2))  # [B, THW, Ci]
        ph = at_least_float32(phi.flatten(2))  # [B, Ci, P]
        gg = g.flatten(2).transpose(1, 2)  # [B, P, Ci]
        aff = torch.matmul(th, ph)
        if self.instantiation == "softmax":
            aff = torch.softmax(aff * self.dim_inner ** -0.5, dim=2)
        else:
            aff = aff / aff.shape[2]
        out = torch.matmul(at_least_float32(aff.to(gg.dtype)),
                           at_least_float32(gg)).to(x.dtype)
        out = out.transpose(1, 2).reshape(B, self.dim_inner, T, H, W)
        return x + self.bn(conv(out, self.conv_out), train)


class ResStage(nn.Module):
    """A stage over the pathways (reference resnet_helper.py:519-726):
    ``pathway{p}_res{i}`` blocks, the first with the stage's stride, the
    first ``num_block_temp_kernel`` of them cycling through the temporal
    kernel sizes and the rest 1; ``pathway{p}_nonlocal{i}`` after the
    blocks of ``nonlocal_inds``."""

    def __init__(self, dim_in: Sequence[int], dim_out, stride,
                 temp_kernel_sizes, num_blocks, dim_inner, num_groups,
                 num_block_temp_kernel, nonlocal_inds, nonlocal_pool,
                 dilation, instantiation, trans_func_name, norm,
                 stride_1x1=False, drop_connect_rate=0.0):
        super().__init__()
        self.num_blocks = list(num_blocks)
        self.nonlocal_inds = [list(n) for n in nonlocal_inds]
        for p in range(len(temp_kernel_sizes)):
            temps = ((list(temp_kernel_sizes[p]) * num_blocks[p])
                     [:num_block_temp_kernel[p]]
                     + [1] * (num_blocks[p] - num_block_temp_kernel[p]))
            for i in range(num_blocks[p]):
                self.add_module(f"pathway{p}_res{i}", ResBlock(
                    dim_in[p] if i == 0 else dim_out[p], dim_out[p], temps[i],
                    stride[p] if i == 0 else 1, trans_func_name, dim_inner[p],
                    num_groups[p], norm, stride_1x1, dilation[p], i,
                    drop_connect_rate))
                if i in self.nonlocal_inds[p]:
                    self.add_module(f"pathway{p}_nonlocal{i}", Nonlocal(
                        dim_out[p], dim_out[p] // 2, nonlocal_pool[p],
                        instantiation, norm))

    def forward(self, xs, train=False, generator=None):
        out = []
        for p, x in enumerate(xs):
            for i in range(self.num_blocks[p]):
                x = getattr(self, f"pathway{p}_res{i}")(x, train, generator)
                if i in self.nonlocal_inds[p]:
                    x = getattr(self, f"pathway{p}_nonlocal{i}")(x, train)
            out.append(x)
        return out
