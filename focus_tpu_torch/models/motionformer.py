"""Motionformer: trajectory-attention video ViT (counterpart of
``focus_tpu/models/motionformer.py``).

Rebuild of the reference model (reference
``slowfast/models/video_model_builder.py:1103-1353`` and
``slowfast/models/attention.py:434-557``) as ``nn.Module``s over
channels-last video ``[B, T, H, W, C]``. Module and parameter names are the
upstream torch names, so ``load_state_dict(strict=True)`` takes a reference
``state_dict`` directly.

Numerics follow the JAX package: float32 master weights, dense layers and
activations at the compute dtype (``TPU.COMPUTE_DTYPE``), LayerNorm
statistics in float32 with eps 1e-6, the classifier head and the eval
softmax in float32. ``forward(train=True)`` returns float32 logits and
applies stochastic depth (``DropPath``) from an explicit
``torch.Generator``. The unscanned, unpipelined form, without dropout.
``TPU.MOE.NUM_EXPERTS > 1`` makes the MLP of every trajectory block a
Switch-routed MoE (``models/moe.py``; ORViT blocks keep the dense MLP); a
train-mode forward given a list as ``moe_aux`` appends each MoE layer's
load-balance value to it, in block order.

Trajectory attention takes both of the reference's forms: the original
code (the default; the fused trajectory core, whose kernel version the
module constant ``ops/trajectory_block.FWD_VERSION`` selects: 4, 3 or 7
(the same function in one launch, v7 with a transposed stage 1), or the
JAX package's variants 5 and 6, which agree with 4 only where every head's
stage-1 weights agree)
and learned values (``use_original_code=False`` on ``TrajectoryAttention``
and ``TrajectoryAttentionBlock``, through the space-stage kernel). As in
the JAX package, no config key reaches the latter from ``Motionformer``.

The serving variants are labeled, as in the JAX package:
``TPU.INT8_SERVING`` runs the big dense layers (qkv and proj of both
attentions, fc1 and fc2 of every MLP) as dynamic W8A8 dense layers
(``ops/quant.py``) in eval only; ``TPU.FAST_GELU`` takes the tanh GELU in
train and eval alike.
"""

import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from focus_tpu_torch.models.build import register
from focus_tpu_torch.models.common import layer_norm, linear
from focus_tpu_torch.models.moe import MoEMlp
from focus_tpu_torch.ops import attention as attn_ops
from focus_tpu_torch.ops.patch_embed import patch_embed_3d, patch_embed_reference
from focus_tpu_torch.ops.quant import quantized_linear
from focus_tpu_torch.ops.trajectory_attention import space_stage
from focus_tpu_torch.ops.trajectory_block import (
    fused_trajectory_core,
    trajectory_core_reference,
)


def drop_path(x, drop_prob: float, generator=None):
    """Stochastic depth per sample (reference ORViT/orvit.py:13-26): each
    sample's branch is kept with probability 1 - drop_prob and then scaled
    by 1 / (1 - drop_prob). ``generator`` draws the mask (None: the global
    generator of x's device)."""
    keep = 1.0 - drop_prob
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    u = torch.rand(shape, generator=generator, device=x.device)
    mask = torch.floor(keep + u).to(x.dtype)
    return x / keep * mask


class DropPath(nn.Module):
    """``drop_path`` at a fixed rate in training; the identity in eval or at
    rate 0."""

    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = float(drop_prob)

    def forward(self, x, train: bool = False, generator=None):
        if not train or self.drop_prob == 0.0:
            return x
        return drop_path(x, self.drop_prob, generator)


def int8_or_dense(x, layer: nn.Linear, quant: bool):
    """One dense layer: W8A8 (``ops/quant.py``) where ``quant`` (int8
    serving, eval), else at x's dtype. The parameters are the same either
    way, so one state_dict serves both."""
    return quantized_linear(x, layer) if quant else linear(x, layer)


class Mlp(nn.Module):
    """ViT MLP (reference ORViT/utils.py:79-98): exact-erf GELU, or the tanh
    form with ``fast_gelu`` (flax's ``nn.gelu(approximate=True)``);
    ``int8_dense`` makes fc1 and fc2 W8A8 in eval."""

    def __init__(self, in_features, hidden_features, out_features=None,
                 fast_gelu=False, int8_dense=False):
        super().__init__()
        self.fast_gelu, self.int8_dense = fast_gelu, int8_dense
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features or in_features)

    def forward(self, x, train=False):
        quant = self.int8_dense and not train
        h = int8_or_dense(x, self.fc1, quant)
        h = F.gelu(h, approximate="tanh" if self.fast_gelu else "none")
        return int8_or_dense(h, self.fc2, quant)


class TrajectoryAttention(nn.Module):
    """(reference attention.py:479-557), in both of its forms.

    ``use_original_code=True`` (the default, as in the JAX package and the
    reference's checkpoints): the stage-2 values are the stage-1
    aggregates, so only the k half of ``proj_kv`` is read, and the non-CLS
    tokens go through the fused trajectory core (``ops/trajectory_block.py``:
    a CUDA kernel on the card, the version ``FWD_VERSION`` names; its plain
    version on the CPU).

    ``use_original_code=False`` (learned values): stage 1 alone through the
    space-stage kernel (``ops/trajectory_attention.py``; its plain version on
    the CPU), then ``proj_q`` over the own-frame aggregates, ``proj_kv`` over
    all of them (a plain GEMM, as ``nn.Dense`` is in JAX), and the temporal
    stage over the learned k2 and v2.

    ``use_kernels=False`` runs the plain versions anywhere. ``int8_dense``
    makes qkv and proj W8A8 in eval; proj_q and proj_kv stay at the compute
    dtype."""

    def __init__(self, dim, num_heads=8, qkv_bias=False, attn_drop=0.0,
                 int8_dense=False, use_original_code=True):
        super().__init__()
        if attn_drop > 0.0:
            raise NotImplementedError("attention dropout (training only)")
        self.num_heads = num_heads
        self.int8_dense = int8_dense
        self.use_original_code = use_original_code
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj_q = nn.Linear(dim, dim, bias=qkv_bias)
        self.proj_kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, thw, with_cls_token=True, use_kernels=True,
                train=False):
        B, N, C = x.shape
        nf = thw[0]
        h = self.num_heads
        hd = C // h
        scale = hd ** -0.5
        quant = self.int8_dense and not train
        q, k, v = int8_or_dense(x, self.qkv, quant).chunk(3, dim=-1)

        def split_heads(t):
            return t.reshape(B, -1, h, hd).transpose(1, 2).reshape(
                B * h, -1, hd)

        if with_cls_token:
            cls_out = attn_ops.cls_attention(
                split_heads(q[:, :1]), split_heads(k), split_heads(v), scale
            ).reshape(B, h, 1, hd).transpose(1, 2).reshape(B, 1, C)

        start = 1 if with_cls_token else 0
        if not self.use_original_code:
            out = self._learned_v(*(split_heads(t[:, start:]).contiguous()
                                    for t in (q, k, v)),
                                  B, nf, scale, use_kernels)
            if with_cls_token:
                out = torch.cat([cls_out, out], dim=1)
            return int8_or_dense(out, self.proj, quant)
        q_p = q[:, start:].contiguous()
        n_per_f = q_p.shape[1] // nf
        kf = k[:, start:].reshape(B, nf, n_per_f, C).contiguous()
        vf = v[:, start:].reshape(B, nf, n_per_f, C).contiguous()
        dt = q_p.dtype
        zeros = torch.zeros(C, dtype=dt, device=x.device)
        wq2 = self.proj_q.weight.t().to(dt).contiguous()
        wk2 = self.proj_kv.weight[:C].t().to(dt).contiguous()
        bq2 = zeros if self.proj_q.bias is None else self.proj_q.bias.to(dt)
        bk2 = zeros if self.proj_kv.bias is None else self.proj_kv.bias[:C].to(dt)
        core = fused_trajectory_core if use_kernels else trajectory_core_reference
        out = core(q_p, kf, vf, wq2, bq2.contiguous(), wk2, bk2.contiguous(),
                   scale, h)
        if with_cls_token:
            out = torch.cat([cls_out, out], dim=1)
        return int8_or_dense(out, self.proj, quant)

    def _learned_v(self, q_, k_, v_, B, nf, scale, use_kernels):
        """The non-CLS tokens with learned values (JAX
        ``models/motionformer.py:250-294``): q_, k_, v_ [B*h, S, hd]."""
        h = self.num_heads
        BH, S, hd = q_.shape
        C = h * hd
        xs = space_stage(q_, k_, v_, nf, scale, use_kernels=use_kernels)
        xs = xs.reshape(B, h, S, nf, hd).permute(0, 2, 3, 1, 4).reshape(
            B, S, nf, C)
        q2 = linear(attn_ops.take_diagonal(xs, nf), self.proj_q)
        k2, v2 = linear(xs, self.proj_kv).chunk(2, dim=-1)
        return attn_ops.temporal_stage(q2, k2, v2, xs, nf, scale, h,
                                       use_original_code=False)


class TrajectoryAttentionBlock(nn.Module):
    """(reference attention.py:443-476); with ``moe_experts`` > 1 its MLP is
    ``moe.MoEMlp`` (JAX ``_block_mlp``), whose experts stay at the compute
    dtype under ``int8_dense``."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=False,
                 attn_drop=0.0, drop_path_rate=0.0, fast_gelu=False,
                 int8_dense=False, use_original_code=True, moe_experts=0,
                 moe_capacity=1.25):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = TrajectoryAttention(dim, num_heads, qkv_bias, attn_drop,
                                        int8_dense, use_original_code)
        self.drop_path = DropPath(drop_path_rate)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.moe = moe_experts > 1
        if self.moe:
            self.mlp = MoEMlp(dim, int(dim * mlp_ratio), moe_experts,
                              moe_capacity, fast_gelu=fast_gelu)
        else:
            self.mlp = Mlp(dim, int(dim * mlp_ratio), fast_gelu=fast_gelu,
                           int8_dense=int8_dense)

    def forward(self, x, metadata, thw, use_kernels=True, train=False,
                generator=None, moe_aux=None):
        y = self.attn(layer_norm(x, self.norm1), thw, use_kernels=use_kernels,
                      train=train)
        x = x + self.drop_path(y, train, generator)
        if self.moe:
            y, aux = self.mlp(layer_norm(x, self.norm2), train, generator)
            if moe_aux is not None:
                moe_aux.append(aux)
        else:
            y = self.mlp(layer_norm(x, self.norm2), train)
        return x + self.drop_path(y, train, generator)


class SelfAttention(nn.Module):
    """Joint space-time MHA (reference attention.py:355-385)."""

    def __init__(self, dim, num_heads=8, qkv_bias=False, int8_dense=False):
        super().__init__()
        self.num_heads = num_heads
        self.int8_dense = int8_dense
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, train=False):
        B, N, C = x.shape
        h = self.num_heads
        hd = C // h
        quant = self.int8_dense and not train
        qkv = int8_or_dense(x, self.qkv, quant).reshape(B, N, 3, h, hd)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        out = attn_ops.joint_attention(qkv[0], qkv[1], qkv[2], hd ** -0.5)
        return int8_or_dense(out.transpose(1, 2).reshape(B, N, C), self.proj,
                             quant)


class SelfAttentionBlock(nn.Module):
    """(reference attention.py:388-432, 'SeltAttentionBlock')"""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=False,
                 fast_gelu=False, int8_dense=False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = SelfAttention(dim, num_heads, qkv_bias, int8_dense)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), fast_gelu=fast_gelu,
                       int8_dense=int8_dense)

    def forward(self, x, train=False):
        x = x + self.attn(layer_norm(x, self.norm1), train)
        return x + self.mlp(layer_norm(x, self.norm2), train)


class ConvWeights(nn.Module):
    """Holds a Conv3d's parameters in the torch layout [D, C, kt, kh, kw]."""

    def __init__(self, in_chans, dim, kernel):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, in_chans, *kernel))
        self.bias = nn.Parameter(torch.empty(dim))


class PatchEmbed3D(nn.Module):
    """3D conv tokenizer (reference stem_helper.py:290-321) with
    stride == kernel: [B, T, H, W, C] -> tokens [B, T'*H'*W', dim], through
    the patch-embed kernel (or its plain version when ``use_kernels`` is
    False). The weight is reshaped to the JAX layout at the call."""

    def __init__(self, dim, kernel, stride, in_chans=3):
        super().__init__()
        if tuple(kernel) != tuple(stride):
            raise NotImplementedError("patch embed with stride != kernel")
        self.kernel = tuple(kernel)
        self.proj = ConvWeights(in_chans, dim, self.kernel)

    def forward(self, x, dtype, use_kernels=True):
        w = self.proj.weight.permute(2, 3, 4, 1, 0)  # [kt, kh, kw, C, D]
        if use_kernels:
            return patch_embed_3d(x, w, self.proj.bias, self.kernel, dtype)
        kt, kh, kw = self.kernel
        _, T, H, W, _ = x.shape
        return (patch_embed_reference(x, w, self.proj.bias, self.kernel, dtype),
                (T // kt, H // kh, W // kw))


EK_CLASSES = (97, 300)  # EPIC-Kitchens verbs and nouns


def _keys_cubic(x):
    """Keys' cubic convolution kernel with a = -0.5 at distances x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def bicubic_weights(n_in: int, n_out: int, device=None):
    """[n_in, n_out] float64 weights of ``jax.image.resize(..., "bicubic")``
    along one axis (its ``compute_weight_mat`` with antialiasing, no
    translation): output j samples input position (j + 0.5) n_in / n_out -
    0.5 (half-pixel centres) with Keys' cubic, a = -0.5, widened by n_in /
    n_out on a downscale; taps outside the input are dropped and each
    output's weights renormalised to sum to 1 (not clamped to the edge).
    ``F.interpolate``'s bicubic (a = -0.75, edge clamping) is another
    function."""
    eps32 = float(np.finfo(np.float32).eps)
    inv = n_in / n_out
    sample = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5
              ) * inv - 0.5
    src = torch.arange(n_in, dtype=torch.float64, device=device)
    w = _keys_cubic((sample[None, :] - src[:, None]).abs() / max(inv, 1.0))
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * eps32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate_pos_embed(pos_embed, npatch: int):
    """The position embedding [1, 1 + npatch, D] for ``npatch`` patches
    (JAX ``models/motionformer.py:interpolate_pos_embed``, reference
    video_model_builder.py:1285-1300): the identity where the grid has
    ``npatch`` patches already (the 224 crop), else the CLS row as it is and
    the square spatial grid resized as ``jax.image.resize(grid, (1, side,
    side, D), "bicubic")`` resizes it, by the separable ``bicubic_weights``
    in float64, rows then columns."""
    n = pos_embed.shape[1] - 1
    if npatch == n:
        return pos_embed
    side_in, side = math.isqrt(n), math.isqrt(npatch)
    D = pos_embed.shape[-1]
    grid = pos_embed[0, 1:].double().reshape(side_in, side_in, D)
    w = bicubic_weights(side_in, side, pos_embed.device)
    rows = (w.t() @ grid.reshape(side_in, side_in * D)).reshape(
        side, side_in, D)
    grid = torch.einsum("jJ,IjD->IJD", w, rows).reshape(1, npatch, D)
    return torch.cat([pos_embed[:, :1], grid.to(pos_embed.dtype)], dim=1)


@register
class Motionformer(nn.Module):
    """(reference video_model_builder.py:1103-1353)"""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        from focus_tpu_torch.models.orvit import ORViTBlock

        c = cfg
        unported = {
            "MF.POS_EMBED other than 'separate' on video input":
                c.MF.POS_EMBED != "separate" or not c.MF.VIDEO_INPUT,
            "MF.HEAD_ACT other than 'tanh'": c.MF.USE_MLP and c.MF.HEAD_ACT != "tanh",
            "dropout (MF.DROP, MF.POS_DROPOUT, MF.HEAD_DROPOUT)":
                max(c.MF.DROP, c.MF.POS_DROPOUT, c.MF.HEAD_DROPOUT) > 0.0,
        }
        missing = [k for k, v in unported.items() if v]
        if missing:
            raise NotImplementedError(f"not ported yet: {missing}")
        self.cfg = cfg
        self.dtype = dtype
        self.use_kernels = True
        D = c.MF.EMBED_DIM
        self.embed_dim = D
        self.temporal_resolution = c.MF.TEMPORAL_RESOLUTION
        num_base_patches = (224 // c.MF.PATCH_SIZE) ** 2
        kernel = (c.MF.PATCH_SIZE_TEMP, c.MF.PATCH_SIZE, c.MF.PATCH_SIZE)
        self.patch_embed_3d = PatchEmbed3D(D, kernel, kernel, c.MF.CHANNELS)
        self.cls_token = nn.Parameter(torch.empty(1, 1, D))
        self.pos_embed = nn.Parameter(torch.empty(1, num_base_patches + 1, D))
        self.temp_embed = nn.Parameter(torch.empty(1, self.temporal_resolution, D))

        # stochastic-depth rates as the JAX model sets them: a linspace to
        # MF.DROP_PATH over the trajectory blocks; ORViT blocks are built
        # without one there, so theirs stays 0
        dpr = [float(r) for r in np.linspace(0, c.MF.DROP_PATH, c.MF.DEPTH)]
        blocks = []
        for i in range(c.MF.DEPTH):
            if i in c.ORVIT.LAYERS:
                blocks.append(ORViTBlock(
                    cfg=c, dim=D, num_heads=c.MF.NUM_HEADS,
                    mlp_ratio=c.MF.MLP_RATIO, qkv_bias=c.MF.QKV_BIAS,
                    attn_drop=c.MF.ATTN_DROPOUT,
                    nb_frames=self.temporal_resolution,
                ))
            else:
                blocks.append(TrajectoryAttentionBlock(
                    D, c.MF.NUM_HEADS, c.MF.MLP_RATIO, c.MF.QKV_BIAS,
                    c.MF.ATTN_DROPOUT, drop_path_rate=dpr[i],
                    fast_gelu=bool(c.TPU.FAST_GELU),
                    int8_dense=bool(c.TPU.INT8_SERVING),
                    moe_experts=int(c.TPU.MOE.NUM_EXPERTS or 0),
                    moe_capacity=float(c.TPU.MOE.CAPACITY_FACTOR),
                ))
        self.blocks = nn.ModuleList(blocks)
        self.norm = nn.LayerNorm(D, eps=1e-6)
        if c.MF.USE_MLP:
            self.pre_logits = nn.Sequential(OrderedDict(fc=nn.Linear(D, D)))
        # EPIC-Kitchens: a verb head and a noun head (head0, head1), as the
        # JAX model sets them whatever MODEL.NUM_CLASSES says
        self.ek_heads = c.TRAIN.DATASET == "epickitchens"
        if self.ek_heads:
            self.head0 = nn.Linear(D, EK_CLASSES[0])
            self.head1 = nn.Linear(D, EK_CLASSES[1])
        else:
            self.head = nn.Linear(D, c.MODEL.NUM_CLASSES)

    def tokenize(self, x):
        """Patch-embed + CLS + separate space and time position embeddings
        -> (tokens, thw)."""
        B = x.shape[0]
        tokens, (_, h_, w_) = self.patch_embed_3d(
            x, self.dtype, use_kernels=self.use_kernels)
        npatch = h_ * w_
        cls_tokens = self.cls_token.to(tokens.dtype).expand(B, 1, -1)
        tokens = torch.cat([cls_tokens, tokens], dim=1)
        pos_embed = interpolate_pos_embed(self.pos_embed, npatch)
        tile_pos = pos_embed[:, 1:].repeat(1, self.temporal_resolution, 1)
        tile_temp = self.temp_embed.repeat_interleave(npatch, dim=1)
        total = torch.cat([self.pos_embed[:, :1], tile_pos + tile_temp], dim=1)
        tokens = tokens + total.to(tokens.dtype)
        side = int(npatch ** 0.5)
        return tokens, (self.temporal_resolution, side, side)

    def forward_features(self, x, metadata, train=False, generator=None,
                         moe_aux=None):
        """x: [B, T, H, W, C] -> pooled feature [B, d]."""
        tokens, thw = self.tokenize(x)
        for blk in self.blocks:
            extra = {"moe_aux": moe_aux} if getattr(blk, "moe", False) else {}
            tokens = blk(tokens, metadata, thw, use_kernels=self.use_kernels,
                         train=train, generator=generator, **extra)
        feat = layer_norm(tokens, self.norm)[:, 0]
        if self.cfg.MF.USE_MLP:
            feat = torch.tanh(linear(feat, self.pre_logits.fc))
        return feat

    def forward(self, x, metadata=None, train: bool = False, generator=None,
                moe_aux=None):
        """Class probabilities [B, num_classes] in float32; with ``train``,
        the float32 logits, stochastic depth drawn from ``generator``. The
        EPIC-Kitchens model returns ``(verb, {"verb": verb, "noun": noun})``
        as the JAX model does, probabilities [B, 97] and [B, 300] (logits
        with ``train``). ``moe_aux``, a list, receives each MoE layer's
        load-balance value (a tensor in the graph), in block order."""
        feat = self.forward_features(x, metadata or {}, train, generator,
                                     moe_aux)
        # the heads run in float32, as flax promotes bf16 features against
        # its float32 kernel
        heads = (self.head0, self.head1) if self.ek_heads else (self.head,)
        outs = [F.linear(feat.float(), h.weight, h.bias) for h in heads]
        if not train:
            outs = [torch.softmax(o, dim=-1) for o in outs]
        if self.ek_heads:
            return outs[0], {"verb": outs[0], "noun": outs[1]}
        return outs[0]
