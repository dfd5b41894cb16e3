"""MViT: the Multiscale Vision Transformer with pooled q / k / v attention
(counterpart of ``focus_tpu/models/mvit.py``; reference
``slowfast/models/video_model_builder.py:764-1100`` and
``slowfast/models/attention.py:16-350``).

Tokens are ``[B, N, C]``; pooling runs on ``[B * heads, head_dim, T, H, W]``
volumes, the ``conv`` mode as a depthwise ``F.conv3d`` (``groups`` =
head_dim), ``max`` as ``F.max_pool3d`` (-inf padding) and ``avg`` as
``F.avg_pool3d`` over the valid cells only, summed in float32. Module and
parameter names are the reference's torch names, so its ``state_dict``
loads by name.

Numerics follow the JAX package: float32 master weights, the stem, the
pooling convolutions and the dense layers at the compute dtype, LayerNorm
statistics in float32 with eps 1e-6, attention logits and softmax in
float32 (``ops/attention.joint_attention``), the head in float32.
``TPU.INT8_SERVING`` makes q, k, v, proj and the MLPs W8A8 dense layers in
eval; ``TPU.FAST_GELU`` takes the tanh GELU. ORViT blocks replace
(``ORVIT.LAYERS``) or are added beside (``ORVIT.ADD_LAYERS``) backbone
blocks, with the frames of each block's tokens. ``DETECTION.ENABLE`` puts
the ResNet family's RoI head on the last tokens.

In training the head's dropout (``MODEL.DROPOUT_RATE``) and stochastic
depth (``MVIT.DROPPATH_RATE``) draw from the caller's ``torch.Generator``.
``MVIT.DROPOUT_RATE`` (the token, attention and MLP dropouts, 0 in every
yaml) is not ported and raises.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from focus_tpu_torch.models.build import register
from focus_tpu_torch.models.common import dropout, layer_norm, linear
from focus_tpu_torch.models.heads import ResNetRoIHead
from focus_tpu_torch.models.motionformer import DropPath, Mlp, int8_or_dense
from focus_tpu_torch.models.norms import at_least_float32
from focus_tpu_torch.ops.attention import joint_attention

LN_EPS = 1e-6


def round_width(width, multiplier, min_width=1, divisor=1):
    """(reference models/utils.py:31-44)"""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


def pool3d(vol, kind: str, kernel, stride, padding):
    """``vol`` [N, C, T, H, W] pooled as the JAX function's
    ``reduce_window`` pools it (torch's ceil_mode=False windows): the max
    with -inf padding, or the sum over the window divided by its count of
    valid cells (summed in at least float32, the result at vol's dtype).
    The padding is explicit: torch's pooling refuses a window longer than
    the unpadded input (2 frames under a kernel of 3)."""
    pads = [p for p in reversed(padding) for _ in (0, 1)]
    if kind == "max":
        return F.max_pool3d(F.pad(vol, pads, value=float("-inf")),
                            tuple(kernel), tuple(stride))
    wide = at_least_float32(vol)
    ones = torch.ones((1, 1) + tuple(vol.shape[2:]), dtype=wide.dtype,
                      device=vol.device)
    summed, counts = (F.avg_pool3d(F.pad(t, pads), tuple(kernel),
                                   tuple(stride), divisor_override=1)
                      for t in (wide, ones))
    return (summed / counts).to(vol.dtype)


def _to_volume(x, thw):
    """[N, L, C] tokens on a T x H x W grid -> [N, C, T, H, W]."""
    return x.reshape(x.shape[0], *thw, x.shape[-1]).permute(0, 4, 1, 2, 3)


def _from_volume(vol):
    """[N, C, T, H, W] -> ([N, T*H*W, C], (T, H, W))."""
    return vol.flatten(2).transpose(1, 2), tuple(vol.shape[2:])


def attention_pool(x, thw, has_cls: bool, mode: str, kernel, stride,
                   conv=None, norm=None):
    """The pooling of one of q, k, v, head by head (reference
    attention.py:16-50): x [B, heads, L, head_dim] -> (pooled x, its (T, H,
    W)). ``conv`` mode: the bias-free depthwise ``conv`` (the reference's
    ``pool_{q,k,v}``) then the LayerNorm ``norm`` over the head dim
    (``norm_{q,k,v}``); ``max`` / ``avg``: ``pool3d`` alone. The CLS token
    is split off before and put back after."""
    B, h, _, C = x.shape
    padding = tuple(int(k // 2) for k in kernel)
    if has_cls:
        cls_tok, x = x[:, :, :1], x[:, :, 1:]
    vol = _to_volume(x.reshape(B * h, -1, C), thw)
    if mode == "conv":
        # a dense NCDHW copy: on the tokens' channels-last view cuDNN runs a
        # depthwise conv3d in bf16 as one kernel and one layout transform
        # per channel (chip_smoke.py phase 17, PERF.md)
        vol = F.conv3d(vol.contiguous(), conv.weight.to(vol.dtype), None,
                       tuple(stride), padding, groups=C)
    else:
        vol = pool3d(vol, mode, kernel, stride, padding)
    x, new_thw = _from_volume(vol)
    x = x.reshape(B, h, -1, C)
    if has_cls:
        x = torch.cat([cls_tok, x], dim=2)
    if mode == "conv":
        x = layer_norm(x, norm)
    return x, new_thw


class MultiScaleAttention(nn.Module):
    """(reference attention.py:52-262). In ``conv`` mode each pooled one of
    q, k, v has its depthwise conv ``pool_{q,k,v}`` and its LayerNorm
    ``norm_{q,k,v}``, as the reference names them."""

    def __init__(self, dim, num_heads, qkv_bias=False, kernel_q=(),
                 kernel_kv=(), stride_q=(), stride_kv=(), has_cls_embed=True,
                 mode="conv", pool_first=False, int8_dense=False):
        super().__init__()
        if mode not in ("conv", "max", "avg"):
            raise NotImplementedError(f"MVIT.MODE {mode!r}")
        self.num_heads, self.mode = num_heads, mode
        self.has_cls_embed, self.pool_first = has_cls_embed, pool_first
        self.int8_dense = int8_dense
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.k = nn.Linear(dim, dim, bias=qkv_bias)
        self.v = nn.Linear(dim, dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        hd = dim // num_heads
        self.pooling = {}  # name -> (kernel, stride) of each pooled one
        for name, kernel, stride in (("q", kernel_q, stride_q),
                                     ("k", kernel_kv, stride_kv),
                                     ("v", kernel_kv, stride_kv)):
            if not kernel:
                continue
            self.pooling[name] = (tuple(kernel), tuple(stride))
            if mode == "conv":
                conv = nn.Conv3d(hd, hd, tuple(kernel), tuple(stride),
                                 tuple(k // 2 for k in kernel), groups=hd,
                                 bias=False)
                conv.init = ("trunc_normal_02", 1.0)
                setattr(self, f"pool_{name}", conv)
                setattr(self, f"norm_{name}", nn.LayerNorm(hd, eps=LN_EPS))

    def _pool(self, name, t, thw):
        if name not in self.pooling:
            return t, thw
        return attention_pool(t, thw, self.has_cls_embed, self.mode,
                              *self.pooling[name],
                              getattr(self, f"pool_{name}", None),
                              getattr(self, f"norm_{name}", None))

    def forward(self, x, thw, train=False):
        B, N, C = x.shape
        h = self.num_heads
        hd = C // h
        quant = self.int8_dense and not train

        def to_heads(t):
            return t.reshape(B, -1, h, hd).transpose(1, 2)

        def from_heads(t):
            return t.transpose(1, 2).reshape(B, -1, C)

        if self.pool_first:
            q = k = v = to_heads(x)
        else:
            q, k, v = (to_heads(int8_or_dense(x, layer, quant))
                       for layer in (self.q, self.k, self.v))
        q, q_thw = self._pool("q", q, thw)
        k, _ = self._pool("k", k, thw)
        v, _ = self._pool("v", v, thw)
        if self.pool_first:
            q, k, v = (to_heads(int8_or_dense(from_heads(t), layer, quant))
                       for t, layer in ((q, self.q), (k, self.k), (v, self.v)))
        out = from_heads(joint_attention(q, k, v, hd ** -0.5))
        return int8_or_dense(out, self.proj, quant), q_thw


class MultiScaleBlock(nn.Module):
    """(reference attention.py:264-350): pooled attention, the residual
    max-pooled at kernel s + 1 where the queries are strided, the MLP to
    ``dim_out``; where the width changes, ``proj`` widens the normed
    tokens (``x_norm``, the reference's order) for the MLP's residual."""

    def __init__(self, dim, dim_out, num_heads, mlp_ratio=4.0, qkv_bias=False,
                 drop_path_rate=0.0, kernel_q=(), kernel_kv=(), stride_q=(),
                 stride_kv=(), mode="conv", has_cls_embed=True,
                 fast_gelu=False, pool_first=False, int8_dense=False):
        super().__init__()
        self.has_cls_embed = has_cls_embed
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiScaleAttention(
            dim, num_heads, qkv_bias, kernel_q, kernel_kv, stride_q,
            stride_kv, has_cls_embed, mode, pool_first, int8_dense)
        self.drop_path = DropPath(drop_path_rate)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim_out,
                       fast_gelu=fast_gelu, int8_dense=int8_dense)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)
        self.stride_skip = tuple(stride_q)
        self.pool_skip = bool(stride_q) and int(np.prod(stride_q)) > 1
        self.kernel_skip = tuple(s + 1 if s > 1 else s for s in stride_q)

    def skip(self, x, thw):
        """The residual, max-pooled as the queries are."""
        if not self.pool_skip:
            return x
        if self.has_cls_embed:
            cls_tok, x = x[:, :1], x[:, 1:]
        vol = pool3d(_to_volume(x, thw), "max", self.kernel_skip,
                     self.stride_skip, [k // 2 for k in self.kernel_skip])
        x = _from_volume(vol)[0]
        return torch.cat([cls_tok, x], dim=1) if self.has_cls_embed else x

    def forward(self, x, thw, train=False, generator=None):
        y, new_thw = self.attn(layer_norm(x, self.norm1), thw, train)
        x = self.skip(x, thw) + self.drop_path(y, train, generator)
        x_norm = layer_norm(x, self.norm2)
        x_mlp = self.mlp(x_norm, train)
        if hasattr(self, "proj"):
            x = linear(x_norm, self.proj)
        return x + self.drop_path(x_mlp, train, generator), new_thw


class TransformerBasicHead(nn.Module):
    """(reference head_helper.py:363-419): dropout, the projection in
    float32 (flax promotes the features against its float32 kernel), the
    activation in eval. A dict of class counts (EPIC-Kitchens) gives one
    projection each (``projection_verb``, ...) and returns ``(zeros(1),
    {name: preds})``."""

    def __init__(self, dim, num_classes, dropout_rate=0.0, act_func="softmax"):
        super().__init__()
        self.dropout_rate, self.act_func = dropout_rate, act_func
        self.names = (list(num_classes) if isinstance(num_classes, dict)
                      else None)
        if self.names is None:
            self.projection = nn.Linear(dim, num_classes)
        else:
            for name, n in num_classes.items():
                setattr(self, f"projection_{name}", nn.Linear(dim, n))

    def _project(self, x, layer, train):
        x = at_least_float32(x)
        out = F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))
        if train:
            return out
        return torch.softmax(out, -1) if self.act_func == "softmax" else (
            torch.sigmoid(out))

    def forward(self, x, train=False, generator=None):
        x = dropout(x, self.dropout_rate, train, generator)
        if self.names is None:
            return self._project(x, self.projection, train)
        preds = {k: self._project(x, getattr(self, f"projection_{k}"), train)
                 for k in self.names}
        return torch.zeros((1,), dtype=x.dtype, device=x.device), preds


def _conv_out(size, kernel, stride, pad):
    return (size + 2 * pad - kernel) // stride + 1


def _schedules(c, depth):
    """Each block's q / kv pooling kernels and strides (reference
    video_model_builder.py:854-900)."""
    pool_q = [[] for _ in range(depth)]
    pool_kv = [[] for _ in range(depth)]
    stride_q = [[] for _ in range(depth)]
    stride_kv = [[] for _ in range(depth)]

    def kernel_of(strides):
        if c.MVIT.POOL_KVQ_KERNEL is not None:
            return list(c.MVIT.POOL_KVQ_KERNEL)
        return [s + 1 if s > 1 else s for s in strides]

    for entry in c.MVIT.POOL_Q_STRIDE or []:
        i = int(entry[0])
        stride_q[i] = list(entry[1:])
        pool_q[i] = kernel_of(entry[1:])
    kv_strides = c.MVIT.POOL_KV_STRIDE
    if c.MVIT.POOL_KV_STRIDE_ADAPTIVE is not None:
        skv = list(c.MVIT.POOL_KV_STRIDE_ADAPTIVE)
        kv_strides = []
        for i in range(depth):
            if stride_q[i]:
                skv = [max(skv[d] // stride_q[i][d], 1) for d in range(3)]
            kv_strides.append([i] + skv)
    for entry in kv_strides or []:
        i = int(entry[0])
        stride_kv[i] = list(entry[1:])
        pool_kv[i] = kernel_of(entry[1:])
        if c.MVIT.POOL_KV_IGNORE_111_KERNEL and tuple(entry[1:]) == (1, 1, 1):
            pool_kv[i] = []
    return pool_q, pool_kv, stride_q, stride_kv


@register
class MViT(nn.Module):
    """(reference video_model_builder.py:764-1100).

    ``forward(x, metadata=None, train=False, generator=None, bboxes=None)``
    takes a clip ``[B, T, H, W, 3]`` (or the loader's one-pathway list) at
    ``DATA.TRAIN_CROP_SIZE``, whose token grid the position embeddings are
    made for. It returns float32 logits in training and the head's
    probabilities in eval; the EPIC-Kitchens head ``(zeros(1), {"verb",
    "noun"})``; with ``DETECTION.ENABLE`` the RoI head's per-box
    probabilities of ``bboxes``. ORViT blocks read
    ``metadata["orvit_bboxes"]``."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        c = cfg
        if c.MVIT.NORM != "layernorm":
            # reference video_model_builder.py:802-805 supports only
            # layernorm; the JAX model raises too
            raise NotImplementedError(
                f"MVIT.NORM={c.MVIT.NORM!r}: only 'layernorm' is supported")
        if c.MVIT.DROPOUT_RATE > 0.0:
            raise NotImplementedError(
                "not ported yet: MVIT.DROPOUT_RATE > 0 (the token, attention "
                "and MLP dropouts; 0 in every MViT yaml)")
        self.cfg, self.dtype = cfg, dtype
        self.use_2d = bool(c.MVIT.PATCH_2D)
        self.cls_on = bool(c.MVIT.CLS_EMBED_ON)
        self.sep_pos = bool(c.MVIT.SEP_POS_EMBED)
        self.detection = bool(c.DETECTION.ENABLE)
        D, depth = c.MVIT.EMBED_DIM, c.MVIT.DEPTH
        num_classes = c.MODEL.NUM_CLASSES
        if c.TRAIN.DATASET == "epickitchens":
            num_classes = {"verb": 97, "noun": 300}

        kernel = list(c.MVIT.PATCH_KERNEL)
        stride = list(c.MVIT.PATCH_STRIDE)
        pad = list(c.MVIT.PATCH_PADDING)
        conv = nn.Conv2d if self.use_2d else nn.Conv3d
        in_chans = c.DATA.INPUT_CHANNEL_NUM[0]
        self.patch_embed = nn.Module()
        self.patch_embed.proj = conv(in_chans, D, tuple(kernel), tuple(stride),
                                     tuple(pad))
        self.patch_embed.proj.init = ("xavier", 1.0)
        crop = c.DATA.TRAIN_CROP_SIZE
        if self.use_2d:
            T = c.DATA.NUM_FRAMES
            kernel, stride, pad = [1] + kernel, [1] + stride, [0] + pad
        else:
            T = _conv_out(c.DATA.NUM_FRAMES, kernel[0], stride[0], pad[0])
        Hh = _conv_out(crop, kernel[1], stride[1], pad[1])
        Ww = _conv_out(crop, kernel[2], stride[2], pad[2])
        if self.cls_on:
            self.cls_token = nn.Parameter(torch.empty(1, 1, D))
        if self.sep_pos:
            self.pos_embed_spatial = nn.Parameter(torch.empty(1, Hh * Ww, D))
            self.pos_embed_temporal = nn.Parameter(torch.empty(1, T, D))
            if self.cls_on:
                self.pos_embed_class = nn.Parameter(torch.empty(1, 1, D))
        else:
            self.pos_embed = nn.Parameter(
                torch.empty(1, T * Hh * Ww + int(self.cls_on), D))
        if c.MVIT.NORM_STEM:
            self.norm_stem = nn.LayerNorm(D, eps=LN_EPS)

        dim_mul, head_mul = np.ones(depth + 1), np.ones(depth + 1)
        for i, m in c.MVIT.DIM_MUL or []:
            dim_mul[int(i)] = m
        for i, m in c.MVIT.HEAD_MUL or []:
            head_mul[int(i)] = m
        pool_q, pool_kv, stride_q, stride_kv = _schedules(c, depth)
        dpr = [float(r) for r in np.linspace(0, c.MVIT.DROPPATH_RATE, depth)]
        num_heads, embed_dim = c.MVIT.NUM_HEADS, D
        frames = c.DATA.NUM_FRAMES // (1 if self.use_2d else stride[0])
        blocks, orvit_blocks = [], {}
        for i in range(depth):
            num_heads = round_width(num_heads, head_mul[i])
            embed_dim = round_width(embed_dim, dim_mul[i], divisor=num_heads)
            dim_out = round_width(
                embed_dim, dim_mul[i + 1],
                divisor=round_width(num_heads, head_mul[i + 1]))
            if i in c.ORVIT.LAYERS:
                blocks.append(self._orvit(embed_dim, num_heads, dpr[i],
                                          frames))
            else:
                blocks.append(MultiScaleBlock(
                    embed_dim, dim_out, num_heads, c.MVIT.MLP_RATIO,
                    c.MVIT.QKV_BIAS, dpr[i], pool_q[i], pool_kv[i],
                    stride_q[i], stride_kv[i], c.MVIT.MODE, self.cls_on,
                    fast_gelu=bool(c.TPU.FAST_GELU),
                    pool_first=c.MVIT.POOL_FIRST,
                    int8_dense=bool(c.TPU.INT8_SERVING)))
            if i in c.ORVIT.ADD_LAYERS:
                orvit_blocks[str(i)] = self._orvit(embed_dim, num_heads,
                                                   dpr[i], frames)
            frames //= stride_q[i][0] if stride_q[i] else 1
        self.blocks = nn.ModuleList(blocks)
        if orvit_blocks:
            self.orvit_blocks = nn.ModuleDict(orvit_blocks)
        self.norm = nn.LayerNorm(dim_out, eps=LN_EPS)
        if self.detection:
            d = c.DETECTION
            self.head = ResNetRoIHead(
                [dim_out], num_classes, [(d.ROI_XFORM_RESOLUTION,) * 2],
                [d.SPATIAL_SCALE_FACTOR], c.MODEL.DROPOUT_RATE,
                c.MODEL.HEAD_ACT, d.ALIGNED)
        else:
            self.head = TransformerBasicHead(dim_out, num_classes,
                                             c.MODEL.DROPOUT_RATE,
                                             c.MODEL.HEAD_ACT)

    def _orvit(self, dim, num_heads, drop_path_rate, frames):
        from focus_tpu_torch.models.orvit import ORViTBlock

        c = self.cfg
        return ORViTBlock(cfg=c, dim=dim, num_heads=num_heads,
                          mlp_ratio=c.MVIT.MLP_RATIO, qkv_bias=c.MVIT.QKV_BIAS,
                          attn_drop=c.MVIT.DROPOUT_RATE, nb_frames=frames,
                          drop_path_rate=drop_path_rate)

    def tokenize(self, x):
        """The stem: [B, T, H, W, C] -> (tokens [B, N, D] with the CLS token
        and the position embeddings, (T', H', W'))."""
        B = x.shape[0]
        proj = self.patch_embed.proj
        weight, bias = proj.weight.to(self.dtype), proj.bias.to(self.dtype)
        if self.use_2d:  # flax's 2-D conv on 5-D input: frame by frame
            T = x.shape[1]
            vol = F.conv2d(x.to(self.dtype).flatten(0, 1).permute(0, 3, 1, 2),
                           weight, bias, proj.stride, proj.padding)
            vol = vol.reshape(B, T, *vol.shape[1:]).transpose(1, 2)
        else:
            vol = F.conv3d(x.to(self.dtype).permute(0, 4, 1, 2, 3), weight,
                           bias, proj.stride, proj.padding)
        tokens, thw = _from_volume(vol)
        if self.cls_on:
            tokens = torch.cat([self.cls_token.to(tokens.dtype).expand(
                B, -1, -1), tokens], dim=1)
        if self.sep_pos:
            pe = (self.pos_embed_spatial.repeat(1, thw[0], 1)
                  + self.pos_embed_temporal.repeat_interleave(
                      thw[1] * thw[2], dim=1))
            if self.cls_on:
                pe = torch.cat([self.pos_embed_class, pe], dim=1)
        else:
            pe = self.pos_embed
        tokens = tokens + pe.to(tokens.dtype)
        if hasattr(self, "norm_stem"):
            tokens = layer_norm(tokens, self.norm_stem)
        return tokens, thw

    def forward(self, x, metadata=None, train=False, generator=None,
                bboxes=None):
        if isinstance(x, (list, tuple)):
            (x,) = x
        metadata = metadata or {}
        tokens, thw = self.tokenize(x)
        for i, blk in enumerate(self.blocks):
            x_prev, thw_prev = tokens, thw
            if isinstance(blk, MultiScaleBlock):
                tokens, thw = blk(x_prev, thw_prev, train, generator)
            else:  # an ORViT block in place of the backbone's
                tokens = blk(x_prev, metadata, thw_prev, train=train,
                             generator=generator)
            if hasattr(self, "orvit_blocks") and str(i) in self.orvit_blocks:
                tokens = tokens + self.orvit_blocks[str(i)](
                    x_prev, metadata, thw_prev, train=train,
                    generator=generator)
        tokens = layer_norm(tokens, self.norm)
        if self.detection:
            feats = tokens[:, 1:] if self.cls_on else tokens
            return self.head([_to_volume(feats, thw)], bboxes, train,
                             generator)
        if self.cls_on:
            pooled = tokens[:, 0]
        else:
            pooled = at_least_float32(tokens).mean(dim=1).to(tokens.dtype)
        return self.head(pooled, train, generator)
