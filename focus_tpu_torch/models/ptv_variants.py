"""CSN and R(2+1)D video backbones (counterpart of
``focus_tpu/models/ptv_variants.py``), registered under the reference's
pytorchvideo names (``slowfast/models/ptv_model_builder.py:516-700``) so
``configs/Kinetics/pytorchvideo/*.yaml`` build; ``PTVResNet``,
``PTVSlowFast``, ``PTVX3D`` and ``PTVMViT`` are the native models of the
same architectures.

- CSN (ir-CSN): a bottleneck whose 3x3x3 ``b`` is depthwise and carries
  the block's whole (t, s, s) stride; stem 3x7x7 / (1, 2, 2) with a
  1x3x3 / (1, 2, 2) max pool; stage strides spatial (1, 2, 2, 2), temporal
  (1, 2, 2, 2).
- R(2+1)D: a bottleneck whose ``b`` is a 1x3x3 spatial conv (the spatial
  stride), BN, ReLU, then a 3x1x1 temporal conv (the temporal stride);
  stem 1x7x7 / (1, 2, 2), no pool; stage strides spatial (2, 2, 2, 2),
  temporal (1, 1, 2, 2).

Modules take NCDHW volumes; the models take the loader's pathways as
``models/resnet_video.py``'s do.
"""

import torch
import torch.nn.functional as F
from torch import nn

from focus_tpu_torch.models.build import MODEL_REGISTRY, register
from focus_tpu_torch.models.heads import ResNetBasicHead
from focus_tpu_torch.models.mvit import MViT
from focus_tpu_torch.models.norms import get_norm
from focus_tpu_torch.models.resnet_helper import conv, conv3d, max_pool3d
from focus_tpu_torch.models.resnet_video import (
    X3D,
    ResNet,
    SlowFast,
    VideoModel,
)

_STAGE_DEPTH = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class CSNBottleneck(nn.Module):
    """1x1x1 -> depthwise 3x3x3 (the block's stride) -> 1x1x1."""

    def __init__(self, dim_in, dim_out, dim_inner, stride, norm):
        super().__init__()
        self.a = conv3d(dim_in, dim_inner, (1, 1, 1))
        self.a_bn = norm(dim_inner)
        self.b = conv3d(dim_inner, dim_inner, (3, 3, 3), stride, (1, 1, 1),
                        groups=dim_inner)
        self.b_bn = norm(dim_inner)
        self.c = conv3d(dim_inner, dim_out, (1, 1, 1))
        self.c_bn = norm(dim_out)

    def forward(self, x, train=False):
        x = F.relu(self.a_bn(conv(x, self.a), train))
        x = F.relu(self.b_bn(conv(x, self.b), train))
        return self.c_bn(conv(x, self.c), train)


class R2Plus1DBottleneck(nn.Module):
    """1x1x1 -> [1x3x3 spatial -> BN -> ReLU -> 3x1x1 temporal] -> 1x1x1
    (pytorchvideo's ``create_2plus1d_bottleneck_block``)."""

    def __init__(self, dim_in, dim_out, dim_inner, stride, norm):
        super().__init__()
        t, s = stride[0], stride[1]
        self.a = conv3d(dim_in, dim_inner, (1, 1, 1))
        self.a_bn = norm(dim_inner)
        self.b_xy = conv3d(dim_inner, dim_inner, (1, 3, 3), (1, s, s),
                           (0, 1, 1))
        self.b_xy_bn = norm(dim_inner)
        self.b_t = conv3d(dim_inner, dim_inner, (3, 1, 1), (t, 1, 1),
                          (1, 0, 0))
        self.b_t_bn = norm(dim_inner)
        self.c = conv3d(dim_inner, dim_out, (1, 1, 1))
        self.c_bn = norm(dim_out)

    def forward(self, x, train=False):
        x = F.relu(self.a_bn(conv(x, self.a), train))
        x = F.relu(self.b_xy_bn(conv(x, self.b_xy), train))
        x = F.relu(self.b_t_bn(conv(x, self.b_t), train))
        return self.c_bn(conv(x, self.c), train)


_PTV_TRANS = {"csn": CSNBottleneck, "r2plus1d": R2Plus1DBottleneck}


class PTVResBlock(nn.Module):
    """relu(shortcut + bottleneck), the shortcut a (t, s, s)-strided 1x1x1
    conv and BN where the width or the stride changes."""

    def __init__(self, dim_in, dim_out, dim_inner, stride, trans, norm):
        super().__init__()
        self.branch2 = _PTV_TRANS[trans](dim_in, dim_out, dim_inner, stride,
                                         norm)
        if dim_in != dim_out or any(s != 1 for s in stride):
            self.branch1 = conv3d(dim_in, dim_out, (1, 1, 1), stride)
            self.branch1_bn = norm(dim_out)

    def forward(self, x, train=False):
        f_x = self.branch2(x, train)
        if hasattr(self, "branch1"):
            x = self.branch1_bn(conv(x, self.branch1), train)
        return F.relu(x + f_x)


class PTVStages(nn.Module):
    """Four stages of ``s{i}_res{j}`` blocks; block 0 of each carries the
    stage's stride."""

    def __init__(self, width, depths, spatial_stride, temporal_stride, trans,
                 norm):
        super().__init__()
        self.names = []
        dim_in = width
        for i, blocks in enumerate(depths):
            dim_out = width * 4 * 2 ** i
            for j in range(blocks):
                stride = ((temporal_stride[i], spatial_stride[i],
                           spatial_stride[i]) if j == 0 else (1, 1, 1))
                name = f"s{i + 2}_res{j}"
                self.add_module(name, PTVResBlock(
                    dim_in if j == 0 else dim_out, dim_out, dim_out // 4,
                    stride, trans, norm))
                self.names.append(name)
            dim_in = dim_out

    def forward(self, x, train=False):
        for name in self.names:
            x = getattr(self, name)(x, train)
        return x


class _PTVModel(VideoModel):
    """Stem, ``PTVStages`` and the basic head over one pathway."""

    trans = ""
    stem_kernel = stem_padding = (0, 0, 0)
    stem_pool = False
    spatial_stride = temporal_stride = (1, 1, 1, 1)
    head_frames_div = 1

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__(cfg, dtype)
        c = cfg
        if self.detection:
            raise NotImplementedError(f"DETECTION.ENABLE: {type(self).__name__}"
                                      " has no RoI head")
        norm = get_norm(c)
        w = c.RESNET.WIDTH_PER_GROUP
        self.stem_conv = conv3d(c.DATA.INPUT_CHANNEL_NUM[0], w,
                                self.stem_kernel, (1, 2, 2), self.stem_padding)
        self.stem_bn = norm(w)
        self.stages = PTVStages(w, _STAGE_DEPTH[c.RESNET.DEPTH],
                                self.spatial_stride, self.temporal_stride,
                                self.trans, norm)
        side = c.DATA.TRAIN_CROP_SIZE // 32
        self.head = ResNetBasicHead(
            [w * 32], c.MODEL.NUM_CLASSES,
            [(c.DATA.NUM_FRAMES // self.head_frames_div, side, side)],
            c.MODEL.DROPOUT_RATE, c.MODEL.HEAD_ACT)

    def forward(self, xs, metadata=None, train=False, generator=None,
                bboxes=None):
        x = self.pathways(xs)[0]
        x = F.relu(self.stem_bn(conv(x, self.stem_conv), train))
        if self.stem_pool:
            x = max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        return self.head([self.stages(x, train)], train, generator)


@register
class PTVCSN(_PTVModel):
    """ir-CSN (reference ``ptv_model_builder.py:516-600``)."""

    trans = "csn"
    stem_kernel, stem_padding, stem_pool = (3, 7, 7), (1, 3, 3), True
    spatial_stride, temporal_stride = (1, 2, 2, 2), (1, 2, 2, 2)
    head_frames_div = 8


@register
class PTVR2plus1D(_PTVModel):
    """R(2+1)D (reference ``ptv_model_builder.py:601-700``)."""

    trans = "r2plus1d"
    stem_kernel, stem_padding = (1, 7, 7), (0, 3, 3)
    spatial_stride, temporal_stride = (2, 2, 2, 2), (1, 1, 2, 2)
    head_frames_div = 4


MODEL_REGISTRY.update(PTVResNet=ResNet, PTVSlowFast=SlowFast, PTVX3D=X3D,
                      PTVMViT=MViT)
