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
load-balance sums (``moe.LoadBalance``; a pipelined segment's layers one
record) to it, in block order: ``moe.load_balance`` makes the term.

Trajectory attention takes both of the reference's forms: the original
code (the default; the fused trajectory core, whose kernel version the
module constant ``ops/trajectory_block.FWD_VERSION`` selects: 4, 3 or 7
(the same function in one launch, v7 with a transposed stage 1), or the
JAX package's variants 5 and 6, which agree with 4 only where every head's
stage-1 weights agree)
and learned values (``use_original_code=False`` on ``TrajectoryAttention``
and ``TrajectoryAttentionBlock``, through the space-stage kernel). As in
the JAX package, no config key reaches the latter from ``Motionformer``.

Tensor and sequence parallelism (``parallel/tensor.py``, after
``shard_model``): under ``TPU.MESH.MODEL`` the MLPs are column then row
parallel with one all-reduce, and a trajectory attention's ``qkv`` is
column parallel, so a model rank holds H / MODEL heads. The fused core
mixes every head in stage 2 (q2 = x_diag Wq2, k2 = xs_f Wk2 over all C),
so q, k and v are gathered over the model line and the core runs on all
heads on every model rank, as GSPMD runs a custom call it cannot
partition; the rank's channels of its output (a split whose backward
all-gathers, so kernel 7 takes the whole gradient) go into the
row-parallel ``proj``. The CLS attention and ``SelfAttention`` split by
heads. Under ``TPU.MESH.SEQ`` a seq rank holds the CLS row and the patch
tokens of F / SEQ frames (``tokenize`` embeds its tubelets alone); K and V
of the patch tokens are gathered over the seq line (a reduce-scatter
backward) and the core takes the rank's window of query frames
(``ops/trajectory_block.py``, ``f0``). Every seq rank holds the CLS row;
the loss gradient enters it on seq rank 0 alone (``seq_grad_gate``).
Under ``TPU.MESH.PIPE`` the runs of trajectory blocks that the JAX
package pipelines (``parallel/pipeline.segments``) run as stages over
``PIPE_MICROBATCHES`` microbatches of the batch's rows (``_pipelined``):
a pipe rank holds its stage's blocks, the other blocks run replicated, and
in one process (no pipe axis) every stage runs in turn, the reference.
Kernels 1 and 7 run inside each stage, where the JAX package takes its
XLA attention path. Under ``TPU.MESH.EXPERT`` a MoE MLP runs its rank's
experts (``models/moe.py``).
Under ``TPU.REMAT`` the trajectory blocks that the JAX package stacks
into a scan (a run of more than one between ORViT layers, under
``TPU.SCAN_LAYERS``) are recomputed in the backward
(``torch.utils.checkpoint``, the dense layers' matmul outputs saved as
``dots_with_no_batch_dims_saveable`` saves them, kernel 1 recomputed),
with the same drop-path masks and the generator left where the plain
step leaves it.

The serving variants are labeled, as in the JAX package:
``TPU.INT8_SERVING`` runs the big dense layers (qkv and proj of both
attentions, fc1 and fc2 of every MLP) as dynamic W8A8 dense layers
(``ops/quant.py``) in eval only; ``TPU.FAST_GELU`` takes the tanh GELU in
train and eval alike.
"""

import functools
import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from focus_tpu_torch.models import common
from focus_tpu_torch.models.build import register
from focus_tpu_torch.models.common import layer_norm, linear, uniform
from focus_tpu_torch.models.moe import LoadBalance, MoEMlp
from focus_tpu_torch.ops import attention as attn_ops
from focus_tpu_torch.ops.patch_embed import patch_embed_3d, patch_embed_reference
from focus_tpu_torch.ops.quant import quantized_linear
from focus_tpu_torch.ops.trajectory_attention import space_stage
from focus_tpu_torch.ops.trajectory_block import (
    fused_trajectory_core,
    trajectory_core_reference,
)
from focus_tpu_torch.parallel import mesh, pipeline
from focus_tpu_torch.parallel import tensor as tp


def drop_path(x, drop_prob: float, generator=None):
    """Stochastic depth per sample (reference ORViT/orvit.py:13-26): each
    sample's branch is kept with probability 1 - drop_prob and then scaled
    by 1 / (1 - drop_prob). ``generator`` draws the mask (None: the global
    generator of x's device)."""
    keep = 1.0 - drop_prob
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    u = uniform(shape, generator, x.device)
    mask = torch.floor(keep + u).to(x.dtype)
    return x / keep * mask


def drop_path_mask(rows: int, drop_prob: float, generator, device):
    """The keep mask [rows, 1, 1] (float32, 0 or 1) that ``drop_path``
    draws for a batch of ``rows`` rows."""
    return torch.floor(1.0 - drop_prob
                       + uniform((rows, 1, 1), generator, device))


class DropPath(nn.Module):
    """``drop_path`` at a fixed rate in training; the identity in eval or at
    rate 0. ``mask`` (``drop_path_mask``'s rows for x) stands for the
    draw."""

    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = float(drop_prob)

    def forward(self, x, train: bool = False, generator=None, mask=None):
        if not train or self.drop_prob == 0.0:
            return x
        if mask is not None:
            return x / (1.0 - self.drop_prob) * mask.to(x.dtype)
        return drop_path(x, self.drop_prob, generator)


def remat_blocks(cfg) -> frozenset:
    """The blocks the JAX package stacks into a scanned, rematerialised
    run (``ScannedTrajBlocks`` under ``TPU.REMAT``): every trajectory block
    of a run of more than one between ORViT layers, under
    ``TPU.SCAN_LAYERS``; none without it."""
    if not cfg.TPU.SCAN_LAYERS:
        return frozenset()
    out, run = set(), []
    for i in list(range(cfg.MF.DEPTH)) + [None]:
        if i is not None and i not in cfg.ORVIT.LAYERS:
            run.append(i)
            continue
        if len(run) > 1:
            out.update(run)
        run = []
    return frozenset(out)


# aten ops whose outputs a recomputed block keeps: the dense layers'
# products, matmuls with no batch dims (JAX's
# dots_with_no_batch_dims_saveable); everything else is recomputed
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _remat_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def recomputed(blk, x, metadata, thw, kwargs):
    """``blk(x, metadata, thw, **kwargs)`` under non-reentrant
    ``torch.utils.checkpoint`` with the dense-products policy. The
    recompute in the backward replays the forward's drop-path masks: it
    runs from the generator's state at the forward (and the batch rows
    ``sharded_draws`` held then), and puts the generator back where the
    backward found it. A MoE block's load-balance value is appended once,
    by the forward."""
    from torch.utils.checkpoint import (
        checkpoint,
        create_selective_checkpoint_contexts,
    )

    gen = kwargs.get("generator")
    state = gen.get_state() if gen is not None else None
    shard = common._DRAW_SHARD
    ran = []

    def run(t):
        if not ran:
            ran.append(True)
            return blk(t, metadata, thw, **kwargs)
        again = dict(kwargs)
        if "moe_aux" in again:
            again["moe_aux"] = []
        now = gen.get_state() if gen is not None else None
        prev, common._DRAW_SHARD = common._DRAW_SHARD, shard
        if gen is not None:
            gen.set_state(state)
        try:
            return blk(t, metadata, thw, **again)
        finally:
            common._DRAW_SHARD = prev
            if gen is not None:
                gen.set_state(now)

    return checkpoint(
        run, x, use_reentrant=False, preserve_rng_state=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     _remat_policy))


def int8_or_dense(x, layer: nn.Linear, quant: bool):
    """One dense layer: W8A8 (``ops/quant.py``) where ``quant`` (int8
    serving, eval), else at x's dtype. The parameters are the same either
    way, so one state_dict serves both."""
    return quantized_linear(x, layer) if quant else linear(x, layer)


class Mlp(nn.Module):
    """ViT MLP (reference ORViT/utils.py:79-98): exact-erf GELU, or the tanh
    form with ``fast_gelu`` (flax's ``nn.gelu(approximate=True)``);
    ``int8_dense`` makes fc1 and fc2 W8A8 in eval."""

    par, sharded = None, False

    def __init__(self, in_features, hidden_features, out_features=None,
                 fast_gelu=False, int8_dense=False):
        super().__init__()
        self.fast_gelu, self.int8_dense = fast_gelu, int8_dense
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features or in_features)

    def attach_parallel(self, par, dims):
        """Column then row parallel where the model axis split fc1."""
        self.par = par
        self.sharded = self.fc1.weight.shape[0] != self.fc1.out_features

    def forward(self, x, train=False):
        act = "tanh" if self.fast_gelu else "none"
        if self.sharded:
            h = F.gelu(linear(tp.copy_in(x, self.par), self.fc1),
                       approximate=act)
            return tp.row_linear(h, self.fc2, self.par)
        quant = self.int8_dense and not train
        h = int8_or_dense(x, self.fc1, quant)
        h = F.gelu(h, approximate=act)
        return int8_or_dense(h, self.fc2, quant)


def _check_heads(module, heads, par):
    """A head-split module needs its qkv and proj split and the heads
    dividing over the model line."""
    if not module.sharded:
        return
    if heads % par.model_size or (module.proj.weight.shape[1]
                                  == module.proj.in_features):
        raise NotImplementedError(
            f"{heads} heads of {module.qkv.in_features} channels do not "
            f"split over TPU.MESH.MODEL {par.model_size}")


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
    dtype.

    After ``parallel/tensor.shard_model`` (``par``): under the model axis
    its heads split (the core on the gathered q, k, v of all heads),
    under the seq axis x holds the CLS row and F / SEQ frames of tokens
    (``thw[0]`` stays F) and K, V of every frame are gathered. The
    learned-value form takes neither."""

    par, sharded = None, False

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

    def attach_parallel(self, par, dims):
        self.par = par
        self.sharded = self.qkv.weight.shape[0] != self.qkv.out_features
        _check_heads(self, self.num_heads, par)

    def forward(self, x, thw, with_cls_token=True, use_kernels=True,
                train=False):
        if self.sharded or (self.par is not None and self.par.seq):
            return self._forward_parallel(x, thw, with_cls_token,
                                          use_kernels, train)
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

    def _forward_parallel(self, x, thw, with_cls_token, use_kernels, train):
        """``forward`` on this rank's heads (model axis) and frames (seq
        axis)."""
        if not self.use_original_code:
            raise NotImplementedError(
                "learned-value trajectory attention under TPU.MESH.SEQ or "
                "MODEL (ROADMAP.md section 2)")
        par = self.par
        B, _, C = x.shape
        nf = thw[0]
        hd = C // self.num_heads
        h = self.num_heads // (par.model_size if self.sharded else 1)
        scale = hd ** -0.5
        quant = self.int8_dense and not train and not self.sharded
        if self.sharded:
            x = tp.copy_in(x, par)
        q, k, v = int8_or_dense(x, self.qkv, quant).chunk(3, dim=-1)
        start = 1 if with_cls_token else 0
        kp = tp.gather_seq(k[:, start:], 1, par)  # every frame's tokens
        vp = tp.gather_seq(v[:, start:], 1, par)

        def split_heads(t):
            return t.reshape(B, -1, h, hd).transpose(1, 2).reshape(
                B * h, -1, hd)

        if with_cls_token:
            k_all = torch.cat([k[:, :1], kp], dim=1)
            v_all = torch.cat([v[:, :1], vp], dim=1)
            cls_out = attn_ops.cls_attention(
                split_heads(q[:, :1]), split_heads(k_all), split_heads(v_all),
                scale).reshape(B, h, 1, hd).transpose(1, 2).reshape(
                    B, 1, h * hd)
        # the core on all heads: q, k and v gathered over the model line
        q_p = tp.gather(q[:, start:], -1, par).contiguous()
        kp, vp = tp.gather(kp, -1, par), tp.gather(vp, -1, par)
        n_per_f = kp.shape[1] // nf
        kf = kp.reshape(B, nf, n_per_f, C).contiguous()
        vf = vp.reshape(B, nf, n_per_f, C).contiguous()
        f0 = par.window(nf)[0] if par.seq else 0
        dt = q_p.dtype
        zeros = torch.zeros(C, dtype=dt, device=x.device)
        wq2 = self.proj_q.weight.t().to(dt).contiguous()
        wk2 = self.proj_kv.weight[:C].t().to(dt).contiguous()
        bq2 = zeros if self.proj_q.bias is None else self.proj_q.bias.to(dt)
        bk2 = zeros if self.proj_kv.bias is None else self.proj_kv.bias[:C].to(dt)
        core = fused_trajectory_core if use_kernels else trajectory_core_reference
        out = core(q_p, kf, vf, wq2, bq2.contiguous(), wk2, bk2.contiguous(),
                   scale, self.num_heads, f0)
        out = tp.split(out, -1, par)  # this rank's heads, for the row split
        if with_cls_token:
            out = torch.cat([cls_out, out], dim=1)
        if self.sharded:
            return tp.row_linear(out, self.proj, par)
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
                generator=None, moe_aux=None, drop_masks=(None, None)):
        """``moe_aux``, a list, receives a MoE MLP's ``moe.LoadBalance``;
        ``drop_masks`` stand for the two drop-path draws
        (``drop_path_mask``)."""
        y = self.attn(layer_norm(x, self.norm1), thw, use_kernels=use_kernels,
                      train=train)
        x = x + self.drop_path(y, train, generator, drop_masks[0])
        if self.moe:
            y, aux = self.mlp(layer_norm(x, self.norm2), train, generator,
                              sums=True)
            if moe_aux is not None:
                moe_aux.append(aux)
        else:
            y = self.mlp(layer_norm(x, self.norm2), train)
        return x + self.drop_path(y, train, generator, drop_masks[1])


class SelfAttention(nn.Module):
    """Joint space-time MHA (reference attention.py:355-385)."""

    par, sharded = None, False

    def __init__(self, dim, num_heads=8, qkv_bias=False, int8_dense=False):
        super().__init__()
        self.num_heads = num_heads
        self.int8_dense = int8_dense
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def attach_parallel(self, par, dims):
        """Split by heads where the model axis split qkv."""
        self.par = par
        self.sharded = self.qkv.weight.shape[0] != self.qkv.out_features
        _check_heads(self, self.num_heads, par)

    def forward(self, x, train=False):
        B, N, C = x.shape
        h = self.num_heads
        hd = C // h
        if self.sharded:
            h //= self.par.model_size
            qkv = linear(tp.copy_in(x, self.par), self.qkv).reshape(
                B, N, 3, h, hd).permute(2, 0, 3, 1, 4)
            out = attn_ops.joint_attention(qkv[0], qkv[1], qkv[2], hd ** -0.5)
            return tp.row_linear(out.transpose(1, 2).reshape(B, N, h * hd),
                                 self.proj, self.par)
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
        self.remat_blocks = remat_blocks(c) if c.TPU.REMAT else frozenset()
        # the pipelined runs of blocks (TPU.MESH.PIPE; parallel/pipeline.py)
        self.segments = pipeline.segments(c)
        self.stages = max(int(c.TPU.MESH.PIPE or 1), 1)
        self.microbatches = pipeline.microbatches(c)
        self.dpr = dpr
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

    par = None

    def attach_parallel(self, par, dims):
        self.par = par

    def tokenize(self, x):
        """Patch-embed + CLS + separate space and time position embeddings
        -> (tokens, thw). Under the seq axis the rank's temporal slice of
        the video alone is embedded: its F / SEQ frames of tokens after the
        CLS row (thw keeps all F)."""
        B = x.shape[0]
        F_ = self.temporal_resolution
        f0, nf = (self.par.window(F_) if self.par is not None
                  and self.par.seq else (0, F_))
        if nf != F_:
            kt = x.shape[1] // F_
            x = x[:, f0 * kt:(f0 + nf) * kt].contiguous()
        tokens, (_, h_, w_) = self.patch_embed_3d(
            x, self.dtype, use_kernels=self.use_kernels)
        npatch = h_ * w_
        cls_tokens = self.cls_token.to(tokens.dtype).expand(B, 1, -1)
        tokens = torch.cat([cls_tokens, tokens], dim=1)
        pos_embed = interpolate_pos_embed(self.pos_embed, npatch)
        tile_pos = pos_embed[:, 1:].repeat(1, self.temporal_resolution, 1)
        tile_temp = self.temp_embed.repeat_interleave(npatch, dim=1)
        patches = tile_pos + tile_temp
        if nf != F_:
            patches = patches[:, f0 * npatch:(f0 + nf) * npatch]
        total = torch.cat([self.pos_embed[:, :1], patches], dim=1)
        tokens = tokens + total.to(tokens.dtype)
        side = int(npatch ** 0.5)
        return tokens, (self.temporal_resolution, side, side)

    def forward_features(self, x, metadata, train=False, generator=None,
                         moe_aux=None):
        """x: [B, T, H, W, C] -> pooled feature [B, d]."""
        tokens, thw = self.tokenize(x)
        ends = dict(self.segments)
        i = 0
        while i < len(self.blocks):
            if i in ends:
                tokens = self._pipelined(i, ends[i], tokens, thw, train,
                                         generator, moe_aux)
                i = ends[i]
                continue
            blk = self.blocks[i]
            extra = {"moe_aux": moe_aux} if getattr(blk, "moe", False) else {}
            kwargs = dict(use_kernels=self.use_kernels, train=train,
                          generator=generator, **extra)
            if train and i in self.remat_blocks and torch.is_grad_enabled():
                tokens = recomputed(blk, tokens, metadata, thw, kwargs)
            else:
                tokens = blk(tokens, metadata, thw, **kwargs)
            i += 1
        feat = layer_norm(tokens, self.norm)[:, 0]
        if self.cfg.MF.USE_MLP:
            feat = torch.tanh(linear(feat, self.pre_logits.fc))
        return feat

    def _pipelined(self, first, end, x, thw, train, generator, moe_aux):
        """Blocks [first, end) as a pipelined segment
        (``parallel/pipeline.py``) over M microbatches of this data rank's
        rows (M times the data ranks a process plays alone,
        ``mesh.virtual_data``): the drop-path masks of every layer drawn
        first, in one process's order; each stage's blocks recomputed in
        the backward under ``TPU.REMAT``; a MoE segment's load-balance sums
        gathered over the pipe line into one ``LoadBalance`` [layers, K,
        E], each local microbatch k in JAX microbatch (d M + k) // DATA
        (JAX's microbatch j is rows [j B / M, (j + 1) B / M) of the global
        batch)."""
        stages, virtual = self.stages, mesh.virtual_data()
        m = self.microbatches * virtual
        B = x.shape[0]
        data = mesh.data_size() * virtual
        if B % m:
            pipeline.check_rows(B * mesh.data_size(), data,
                                self.microbatches)
        masks = []
        for i in range(first, end):
            rate = self.dpr[i] if train else 0.0
            masks.append([drop_path_mask(B, rate, generator, x.device)
                          if rate > 0.0 else None for _ in range(2)])
        per = (end - first) // stages
        rows = B // m
        remat = (train and bool(self.cfg.TPU.REMAT)
                 and torch.is_grad_enabled())
        moe = int(self.cfg.TPU.MOE.NUM_EXPERTS or 0) > 1
        place = getattr(self, "pipe_place", None)
        line = place["line"] if place else pipeline.Line()

        def run(xk, k, stage):
            sink = []
            for i in range(first + stage * per, first + (stage + 1) * per):
                mk = tuple(None if t is None else t[k * rows:(k + 1) * rows]
                           for t in masks[i - first])
                kwargs = dict(use_kernels=self.use_kernels, train=train,
                              generator=generator, drop_masks=mk)
                if moe:
                    kwargs["moe_aux"] = sink
                if remat:
                    xk = recomputed(self.blocks[i], xk, {}, thw, kwargs)
                else:
                    xk = self.blocks[i](xk, {}, thw, **kwargs)
            if not sink:
                return pipeline.StageOut(xk)
            return pipeline.StageOut(
                xk, torch.cat([r.probs for r in sink]),
                torch.cat([r.mask for r in sink]),
                torch.cat([r.tokens for r in sink]))

        y, probs, mask, tokens = pipeline.run_schedule(run, x, stages, m,
                                                       line)
        if probs is not None and moe_aux is not None:
            if line.size > 1:  # every stage's layers, in layer order
                probs = tp.gather(probs, 0, None, line.group)
                mask = mesh.all_gather_tiled(mask, line.group)
                tokens = mesh.all_gather_tiled(tokens, line.group)
            groups = [(mesh.data_rank() * m + k) // data for k in range(m)]
            moe_aux.append(LoadBalance(probs, mask, tokens,
                                       (groups, self.microbatches)))
        return y

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
        if self.par is not None:  # the CLS row's loss gradient enters once
            outs = [tp.seq_grad_gate(o, self.par) for o in outs]
        if not train:
            outs = [torch.softmax(o, dim=-1) for o in outs]
        if self.ek_heads:
            return outs[0], {"verb": outs[0], "noun": outs[1]}
        return outs[0]
