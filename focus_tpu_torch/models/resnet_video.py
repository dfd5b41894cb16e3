"""ResNet-family video models: SlowFast, ResNet (C2D / I3D / Slow and their
``_nopool`` forms) and X3D (counterpart of
``focus_tpu/models/resnet_video.py``; reference
``slowfast/models/video_model_builder.py:27-763``).

``forward(xs, metadata=None, train=False, generator=None, bboxes=None)``
takes the loader's pathways: a list of ``[B, T, H, W, C]`` clips (slow,
fast for SlowFast, as ``datasets/utils.pack_pathway_output`` splits them),
or one such tensor for a single-pathway model. Each is cast to the compute
dtype and viewed NCDHW in ``memory_format`` (``torch.contiguous_format``,
the default: a dense NCDHW copy; ``torch.channels_last_3d``: the
channels-last clip's own strides, no copy). In training it returns float32
logits; in eval the head's probabilities, or with ``DETECTION.ENABLE`` the
RoI head's per-box probabilities of ``bboxes``. Dropout and stochastic
depth draw from ``generator``.
"""

import math

import torch
from torch import nn

from focus_tpu_torch.models.build import register
from focus_tpu_torch.models.heads import ResNetBasicHead, ResNetRoIHead, X3DHead
from focus_tpu_torch.models.mvit import round_width
from focus_tpu_torch.models.norms import get_norm
from focus_tpu_torch.models.resnet_helper import (
    ResStage,
    VideoModelStem,
    conv,
    conv3d,
    max_pool3d,
)

_MODEL_STAGE_DEPTH = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

_TEMPORAL_KERNEL_BASIS = {
    "2d": [[[1]], [[1]], [[1]], [[1]], [[1]]],
    "c2d": [[[1]], [[1]], [[1]], [[1]], [[1]]],
    "c2d_nopool": [[[1]], [[1]], [[1]], [[1]], [[1]]],
    "i3d": [[[5]], [[3]], [[3, 1]], [[3, 1]], [[1, 3]]],
    "i3d_nopool": [[[5]], [[3]], [[3, 1]], [[3, 1]], [[1, 3]]],
    "slow": [[[1]], [[1]], [[1]], [[3]], [[3]]],
    "slowfast": [
        [[1], [5]], [[1], [3]], [[1], [3]], [[3], [3]], [[3], [3]],
    ],
    "x3d": [[[5]], [[3]], [[3]], [[3]], [[3]]],
}

_POOL1 = {
    "2d": [[1, 1, 1]],
    "c2d": [[2, 1, 1]],
    "c2d_nopool": [[1, 1, 1]],
    "i3d": [[2, 1, 1]],
    "i3d_nopool": [[1, 1, 1]],
    "slow": [[1, 1, 1]],
    "slowfast": [[1, 1, 1], [1, 1, 1]],
    "x3d": [[1, 1, 1]],
}


class FuseFastToSlow(nn.Module):
    """The fast pathway through a (k, 1, 1) conv of temporal stride alpha,
    BN and ReLU, concatenated to the slow one's channels (reference
    video_model_builder.py:98-155)."""

    def __init__(self, dim_in, fusion_conv_channel_ratio, fusion_kernel, alpha,
                 norm):
        super().__init__()
        self.conv_f2s = conv3d(dim_in, dim_in * fusion_conv_channel_ratio,
                               (fusion_kernel, 1, 1), (alpha, 1, 1),
                               (fusion_kernel // 2, 0, 0))
        self.bn = norm(dim_in * fusion_conv_channel_ratio)

    def forward(self, xs, train=False):
        x_s, x_f = xs
        fuse = torch.relu(self.bn(conv(x_f, self.conv_f2s), train))
        return [torch.cat([x_s, fuse], dim=1), x_f]


def _stage_kwargs(cfg, idx, norm):
    return dict(
        temp_kernel_sizes=_TEMPORAL_KERNEL_BASIS[cfg.MODEL.ARCH][idx + 1],
        stride=list(cfg.RESNET.SPATIAL_STRIDES[idx]),
        num_block_temp_kernel=list(cfg.RESNET.NUM_BLOCK_TEMP_KERNEL[idx]),
        nonlocal_inds=list(cfg.NONLOCAL.LOCATION[idx]),
        nonlocal_pool=list(cfg.NONLOCAL.POOL[idx]),
        dilation=list(cfg.RESNET.SPATIAL_DILATIONS[idx]),
        instantiation=cfg.NONLOCAL.INSTANTIATION,
        trans_func_name=cfg.RESNET.TRANS_FUNC,
        stride_1x1=cfg.RESNET.STRIDE_1X1,
        norm=norm,
    )


def _basic_head(cfg, dim_in, pool_size, frames):
    """The classification head, pooled at the train crop's last-stage size
    (``MULTIGRID.SHORT_CYCLE``: globally)."""
    c = cfg
    side = c.DATA.TRAIN_CROP_SIZE // 32
    sizes = [None if c.MULTIGRID.SHORT_CYCLE else
             (frames[p] // pool_size[p][0], side // pool_size[p][1],
              side // pool_size[p][2]) for p in range(len(dim_in))]
    return ResNetBasicHead(dim_in, c.MODEL.NUM_CLASSES, sizes,
                           c.MODEL.DROPOUT_RATE, c.MODEL.HEAD_ACT)


def _roi_head(cfg, dim_in):
    d = cfg.DETECTION
    n = len(dim_in)
    return ResNetRoIHead(dim_in, cfg.MODEL.NUM_CLASSES,
                         [(d.ROI_XFORM_RESOLUTION,) * 2] * n,
                         [d.SPATIAL_SCALE_FACTOR] * n, cfg.MODEL.DROPOUT_RATE,
                         cfg.MODEL.HEAD_ACT, d.ALIGNED)


class VideoModel(nn.Module):
    """The pathways' entry and the head's call, shared by the models."""

    # dense NCDHW: on an H100 the bf16 forward of SlowFast 8x8 R50 at batch
    # 8 took 42.51 ms against 44.84 in channels_last_3d, its train step
    # 171.16 against 194.38, and X3D-M's depthwise convolutions 0.07-0.25 ms
    # against 1.2-4.3 (chip_smoke.py phase 16, PERF.md)
    memory_format = torch.contiguous_format

    def __init__(self, cfg, dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.detection = bool(cfg.DETECTION.ENABLE)

    def pathways(self, xs):
        if not isinstance(xs, (list, tuple)):
            xs = [xs]
        return [x.to(self.dtype).permute(0, 4, 1, 2, 3).contiguous(
            memory_format=self.memory_format) for x in xs]

    def classify(self, x, train, generator, bboxes):
        if self.detection:
            return self.head(x, bboxes, train, generator)
        return self.head(x, train, generator)


@register
class SlowFast(VideoModel):
    """(reference video_model_builder.py:158-420)"""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__(cfg, dtype)
        c = cfg
        norm = get_norm(c)
        self.pool_size = pool_size = _POOL1[c.MODEL.ARCH]
        d2, d3, d4, d5 = _MODEL_STAGE_DEPTH[c.RESNET.DEPTH]
        ng, w = c.RESNET.NUM_GROUPS, c.RESNET.WIDTH_PER_GROUP
        dim_inner = ng * w
        beta = c.SLOWFAST.BETA_INV
        fr = c.SLOWFAST.FUSION_CONV_CHANNEL_RATIO
        ratio = beta // fr
        tk = _TEMPORAL_KERNEL_BASIS[c.MODEL.ARCH]

        def fuse(dim):
            return FuseFastToSlow(dim, fr, c.SLOWFAST.FUSION_KERNEL_SZ,
                                  c.SLOWFAST.ALPHA, norm)

        self.s1 = VideoModelStem(
            list(c.DATA.INPUT_CHANNEL_NUM), [w, w // beta],
            [tk[0][0] + [7, 7], tk[0][1] + [7, 7]], [[1, 2, 2]] * 2,
            [[tk[0][0][0] // 2, 3, 3], [tk[0][1][0] // 2, 3, 3]], norm)
        self.s1_fuse = fuse(w // beta)
        for i, (mul, nb) in enumerate(((1, d2), (2, d3), (4, d4), (8, d5))):
            din = w * 4 * mul // 2 if i else w
            setattr(self, f"s{i + 2}", ResStage(
                dim_in=[din + din // ratio, din // beta],
                dim_out=[w * 4 * mul, w * 4 * mul // beta],
                dim_inner=[dim_inner * mul, dim_inner * mul // beta],
                num_blocks=[nb] * 2, num_groups=[ng] * 2,
                **_stage_kwargs(c, i, norm)))
            if i < 3:
                setattr(self, f"s{i + 2}_fuse", fuse(w * 4 * mul // beta))
        dim_out = [w * 32, w * 32 // beta]
        if self.detection:
            self.head = _roi_head(c, dim_out)
        else:
            self.head = _basic_head(
                c, dim_out, pool_size,
                [c.DATA.NUM_FRAMES // c.SLOWFAST.ALPHA, c.DATA.NUM_FRAMES])

    def forward(self, xs, metadata=None, train=False, generator=None,
                bboxes=None):
        x = self.s1(self.pathways(xs), train)
        x = self.s1_fuse(x, train)
        x = self.s2(x, train, generator)
        x = self.s2_fuse(x, train)
        x = [max_pool3d(xp, self.pool_size[p], self.pool_size[p])
             for p, xp in enumerate(x)]
        x = self.s3_fuse(self.s3(x, train, generator), train)
        x = self.s4_fuse(self.s4(x, train, generator), train)
        return self.classify(self.s5(x, train, generator), train, generator,
                             bboxes)


@register
class ResNet(VideoModel):
    """Single-pathway C2D / I3D / Slow (reference
    video_model_builder.py:423-615)."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__(cfg, dtype)
        c = cfg
        norm = get_norm(c)
        self.pool_size = pool_size = _POOL1[c.MODEL.ARCH]
        depths = _MODEL_STAGE_DEPTH[c.RESNET.DEPTH]
        ng, w = c.RESNET.NUM_GROUPS, c.RESNET.WIDTH_PER_GROUP
        dim_inner = ng * w
        tk = _TEMPORAL_KERNEL_BASIS[c.MODEL.ARCH]
        self.s1 = VideoModelStem(
            list(c.DATA.INPUT_CHANNEL_NUM), [w], [tk[0][0] + [7, 7]],
            [[1, 2, 2]], [[tk[0][0][0] // 2, 3, 3]], norm)
        din = w
        for i, nb in enumerate(depths):
            mul = 2 ** i
            setattr(self, f"s{i + 2}", ResStage(
                dim_in=[din], dim_out=[w * 4 * mul],
                dim_inner=[dim_inner * mul], num_blocks=[nb],
                num_groups=[ng], **_stage_kwargs(c, i, norm)))
            din = w * 4 * mul
        if self.detection:
            self.head = _roi_head(c, [din])
        else:
            self.head = _basic_head(c, [din], pool_size, [c.DATA.NUM_FRAMES])

    def forward(self, xs, metadata=None, train=False, generator=None,
                bboxes=None):
        x = self.s1(self.pathways(xs), train)
        x = self.s2(x, train, generator)
        x = [max_pool3d(x[0], self.pool_size[0], self.pool_size[0])]
        for i in (3, 4, 5):
            x = getattr(self, f"s{i}")(x, train, generator)
        return self.classify(x, train, generator, bboxes)


@register
class X3D(VideoModel):
    """(reference video_model_builder.py:618-761)"""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__(cfg, dtype)
        c = cfg
        if self.detection:
            raise NotImplementedError("DETECTION.ENABLE: X3D has no RoI head")
        norm = get_norm(c)
        ng = c.RESNET.NUM_GROUPS
        w_mul, d_mul = c.X3D.WIDTH_FACTOR, c.X3D.DEPTH_FACTOR
        dim_c1 = c.X3D.DIM_C1
        dim_res2 = (round_width(dim_c1, 2.0, divisor=8)
                    if c.X3D.SCALE_RES2 else dim_c1)
        dim_res3 = round_width(dim_res2, 2.0, divisor=8)
        dim_res4 = round_width(dim_res3, 2.0, divisor=8)
        dim_res5 = round_width(dim_res4, 2.0, divisor=8)
        block_basis = [(1, dim_res2, 2), (2, dim_res3, 2), (5, dim_res4, 2),
                       (3, dim_res5, 2)]
        tk = _TEMPORAL_KERNEL_BASIS[c.MODEL.ARCH]
        dim_in = round_width(dim_c1, w_mul)
        self.s1 = VideoModelStem(
            list(c.DATA.INPUT_CHANNEL_NUM), [dim_in], [tk[0][0] + [3, 3]],
            [[1, 2, 2]], [[tk[0][0][0] // 2, 1, 1]], norm,
            stem_func_name="x3d_stem")
        for stage, (blocks, dim_base, stride) in enumerate(block_basis):
            dim_out = round_width(dim_base, w_mul)
            dim_inner = int(c.X3D.BOTTLENECK_FACTOR * dim_out)
            n_rep = int(math.ceil(d_mul * blocks)) if d_mul else blocks
            setattr(self, f"s{stage + 2}", ResStage(
                dim_in=[dim_in], dim_out=[dim_out], dim_inner=[dim_inner],
                temp_kernel_sizes=tk[1], stride=[stride], num_blocks=[n_rep],
                num_groups=[dim_inner] if c.X3D.CHANNELWISE_3x3x3 else [ng],
                num_block_temp_kernel=[n_rep],
                nonlocal_inds=list(c.NONLOCAL.LOCATION[0]),
                nonlocal_pool=list(c.NONLOCAL.POOL[0]),
                dilation=list(c.RESNET.SPATIAL_DILATIONS[stage]),
                instantiation=c.NONLOCAL.INSTANTIATION,
                trans_func_name=c.RESNET.TRANS_FUNC,
                stride_1x1=c.RESNET.STRIDE_1X1, norm=norm,
                drop_connect_rate=c.MODEL.DROPCONNECT_RATE * (stage + 2)
                / (len(block_basis) + 1)))
            dim_in = dim_out
        spat = int(math.ceil(c.DATA.TRAIN_CROP_SIZE / 32.0))
        self.head = X3DHead(
            dim_in, int(c.X3D.BOTTLENECK_FACTOR * dim_in), c.X3D.DIM_C5,
            c.MODEL.NUM_CLASSES, (c.DATA.NUM_FRAMES, spat, spat),
            c.MODEL.DROPOUT_RATE, c.MODEL.HEAD_ACT, c.X3D.BN_LIN5)

    def forward(self, xs, metadata=None, train=False, generator=None,
                bboxes=None):
        x = self.s1(self.pathways(xs), train)
        for i in (2, 3, 4, 5):
            x = getattr(self, f"s{i}")(x, train, generator)
        return self.classify(x, train, generator, bboxes)
