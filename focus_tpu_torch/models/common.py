"""Shared building blocks of the STEVE family (counterpart of
``focus_tpu/models/common.py``; reference ``slowfast/models/STEVE/utils.py``
and ``transformer.py``).

Module and parameter names are the upstream torch names, so a reference
``state_dict`` loads with ``strict=True``. Numerics follow the JAX package:
float32 master weights, dense layers and convolutions at the input's dtype,
LayerNorm statistics in float32 with eps 1e-6, attention logits and softmax
in float32. Each layer carries the name of its JAX initialiser in ``.init``
(read by ``models/build.py:init_weights``). Eval only: dropout rates are
accepted and never applied.
"""

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6  # flax nn.LayerNorm's default (torch's is 1e-5)


def linear(x, layer: nn.Linear):
    """``layer`` applied at x's dtype (float32 weights cast to it)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def layer_norm(x, ln: nn.LayerNorm, dtype=None):
    """LayerNorm with float32 statistics, result at ``dtype`` (default
    x's)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(dtype or x.dtype)


def conv(x, layer: nn.Conv2d):
    """``layer`` applied to NCHW ``x`` at x's dtype."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.conv2d(x, layer.weight.to(x.dtype), bias, layer.stride,
                    layer.padding)


def Dense(in_features, out_features, bias=True, weight_init="xavier",
          gain=1.0):
    """An ``nn.Linear`` tagged with its initialiser: xavier-uniform with
    ``gain``, or kaiming-uniform (relu)."""
    layer = nn.Linear(in_features, out_features, bias=bias)
    layer.init = (weight_init, gain)
    return layer


def conv2d(in_channels, out_channels, kernel_size, stride=1, padding=0,
           weight_init="xavier"):
    """Plain conv2d tagged with its initialiser (no activation)."""
    layer = nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding)
    layer.init = (weight_init, 1.0)
    return layer


class Conv2dBlock(nn.Module):
    """Conv2d (kaiming init) + ReLU over NCHW; the conv is attribute ``m``
    as upstream."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0):
        super().__init__()
        self.m = conv2d(in_channels, out_channels, kernel_size, stride,
                        padding, weight_init="kaiming")

    def forward(self, x):
        return F.relu(conv(x, self.m))


class GRUCell(nn.Module):
    """GRU cell with ``torch.nn.GRUCell``'s parameters (gates reset, update,
    new in one [3H] block), computed at the inputs' dtype."""

    def __init__(self, input_size, hidden_size):
        super().__init__()
        H = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(3 * H, input_size))
        self.weight_hh = nn.Parameter(torch.empty(3 * H, H))
        self.bias_ih = nn.Parameter(torch.zeros(3 * H))
        self.bias_hh = nn.Parameter(torch.zeros(3 * H))

    def forward(self, x, h):
        dt = torch.promote_types(x.dtype, h.dtype)
        x, h = x.to(dt), h.to(dt)
        gi = F.linear(x, self.weight_ih.to(dt), self.bias_ih.to(dt))
        gh = F.linear(h, self.weight_hh.to(dt), self.bias_hh.to(dt))
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h


class MultiHeadAttention(nn.Module):
    """Pre-projection multi-head attention of the STEVE transformer
    (reference STEVE/transformer.py:4-49) with the three extra modes of the
    JAX module: ``project_kv_only`` returns the per-head K/V of a
    rollout-constant key set, ``precomputed_kv`` takes them back, and
    ``cache=(k_cache, v_cache, t)`` decodes the single token at position t
    against caches ``[B, L, h, hd]``, which it updates in place."""

    def __init__(self, d_model, num_heads, dropout=0.0, gain=1.0):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.proj_q = Dense(d_model, d_model, bias=False)
        self.proj_k = Dense(d_model, d_model, bias=False)
        self.proj_v = Dense(d_model, d_model, bias=False)
        self.proj_o = Dense(d_model, d_model, bias=False, gain=gain)

    def _heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads, -1)

    def forward(self, q, k, v, causal=False, cache=None, precomputed_kv=None,
                project_kv_only=False):
        if project_kv_only:
            return (self._heads(linear(k, self.proj_k)),
                    self._heads(linear(v, self.proj_v)))
        B, T, _ = q.shape
        scale = (self.d_model // self.num_heads) ** -0.5
        qh = self._heads(linear(q, self.proj_q)) * scale
        if precomputed_kv is not None:
            kh, vh = precomputed_kv
        else:
            kh = self._heads(linear(k, self.proj_k))
            vh = self._heads(linear(v, self.proj_v))

        mask = None
        if cache is not None:
            k_cache, v_cache, t = cache
            k_cache[:, t:t + 1] = kh.to(k_cache.dtype)
            v_cache[:, t:t + 1] = vh.to(v_cache.dtype)
            # rows > t carry softmax weight exactly 0 in the JAX module's
            # fixed-shape form; here they are simply not read
            kh, vh = k_cache[:, :t + 1], v_cache[:, :t + 1]
        elif causal:
            S = kh.shape[1]
            mask = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()

        logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        attn = torch.softmax(logits, dim=-1).to(qh.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vh.to(attn.dtype))
        out = linear(out.reshape(B, T, self.d_model), self.proj_o)
        if cache is not None:
            return out, (k_cache, v_cache)
        return out


def FFN(d_model, dropout=0.0, gain=1.0):
    """linear(kaiming) / relu / linear(gain), an ``nn.Sequential`` as
    upstream (indices 0 and 2)."""
    del dropout
    return nn.Sequential(
        Dense(d_model, 4 * d_model, weight_init="kaiming"),
        nn.ReLU(),
        Dense(4 * d_model, d_model, gain=gain),
    )


def ffn(x, seq: nn.Sequential):
    """A linear / ReLU / linear ``nn.Sequential`` applied at x's dtype."""
    return linear(F.relu(linear(x, seq[0])), seq[2])


class TransformerEncoderBlock(nn.Module):
    """Pre-LN encoder block with the reference's ``is_first`` quirk: the
    first block's residual stream starts from the normed input
    (reference STEVE/transformer.py:75-82)."""

    def __init__(self, d_model, num_heads, dropout=0.0, gain=1.0,
                 is_first=False):
        super().__init__()
        self.is_first = is_first
        self.attn_layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = MultiHeadAttention(d_model, num_heads, dropout, gain)
        self.ffn_layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ffn = FFN(d_model, dropout, gain)

    def forward(self, x):
        y = layer_norm(x, self.attn_layer_norm)
        if self.is_first:
            x = y
        x = x + self.attn(y, y, y)
        return x + ffn(layer_norm(x, self.ffn_layer_norm), self.ffn)


class TransformerEncoder(nn.Module):
    """Encoder blocks + final LayerNorm, 1/sqrt(2N) output gain
    (reference STEVE/transformer.py:89-114)."""

    def __init__(self, num_blocks, d_model, num_heads, dropout=0.0):
        super().__init__()
        gain = (2 * num_blocks) ** -0.5 if num_blocks > 0 else 1.0
        self.blocks = nn.ModuleList(
            TransformerEncoderBlock(d_model, num_heads, dropout, gain,
                                    is_first=(i == 0))
            for i in range(num_blocks))
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return layer_norm(x, self.layer_norm)


class TransformerDecoderBlock(nn.Module):
    """Causal self-attention + cross-attention to the encoder output + FFN
    (reference STEVE/transformer.py:117-164)."""

    def __init__(self, d_model, num_heads, dropout=0.0, gain=1.0,
                 is_first=False, dtype=None):
        super().__init__()
        self.is_first, self.dtype = is_first, dtype
        self.self_attn_layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout, gain)
        self.encoder_decoder_attn_layer_norm = nn.LayerNorm(d_model,
                                                            eps=LN_EPS)
        self.encoder_decoder_attn = MultiHeadAttention(d_model, num_heads,
                                                       dropout, gain)
        self.ffn_layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ffn = FFN(d_model, dropout, gain)

    def forward(self, x, enc_out, cache=None, cross_kv=None,
                project_kv_only=False):
        if project_kv_only:
            return self.encoder_decoder_attn(enc_out, enc_out, enc_out,
                                             project_kv_only=True)
        # the input may be wider than the compute dtype (token + float32
        # position row): the first LayerNorm reads it unrounded
        y = layer_norm(x, self.self_attn_layer_norm, self.dtype)
        if self.is_first:
            x = y
        new_cache = None
        if cache is not None:
            a, new_cache = self.self_attn(y, y, y, cache=cache)
        else:
            a = self.self_attn(y, y, y, causal=True)
        x = x + a
        y = layer_norm(x, self.encoder_decoder_attn_layer_norm)
        x = x + self.encoder_decoder_attn(y, enc_out, enc_out,
                                          precomputed_kv=cross_kv)
        x = x + ffn(layer_norm(x, self.ffn_layer_norm), self.ffn)
        if cache is not None:
            return x, new_cache
        return x


class TransformerDecoder(nn.Module):
    """Decoder blocks + final LayerNorm, 1/sqrt(3N) gain
    (reference STEVE/transformer.py:167-193). ``caches`` is one
    ``(k_cache, v_cache)`` pair per block and ``t`` the position decoded;
    ``project_kv_only`` returns each block's cross-attention K/V of
    ``enc_out``. ``dtype`` is the compute dtype the first LayerNorm rounds
    to (default: the input's)."""

    def __init__(self, num_blocks, d_model, num_heads, dropout=0.0,
                 dtype=None):
        super().__init__()
        self.num_blocks, self.num_heads = num_blocks, num_heads
        gain = (3 * num_blocks) ** -0.5 if num_blocks > 0 else 1.0
        self.blocks = nn.ModuleList(
            TransformerDecoderBlock(d_model, num_heads, dropout, gain,
                                    is_first=(i == 0), dtype=dtype)
            for i in range(num_blocks))
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, enc_out, caches=None, t=None, cross_kvs=None,
                project_kv_only=False):
        if project_kv_only:
            return tuple(blk(x, enc_out, project_kv_only=True)
                         for blk in self.blocks)
        new_caches = []
        for i, blk in enumerate(self.blocks):
            cross_kv = None if cross_kvs is None else cross_kvs[i]
            if caches is not None:
                x, nc = blk(x, enc_out, cache=(*caches[i], t),
                            cross_kv=cross_kv)
                new_caches.append(nc)
            else:
                x = blk(x, enc_out)
        out = layer_norm(x, self.layer_norm)
        if caches is not None:
            return out, tuple(new_caches)
        return out
