"""One fused autoregressive decode step of the STEVE slot rollout: the plain
PyTorch version, the weight packing, and the wrapper of its CUDA kernels
(``csrc/ar_decode.cu``).

Counterpart of ``focus_tpu/ops/pallas/ar_decode.py`` (``fused_ar_step``,
``stack_decoder_params``). One step takes the current token embedding of
every rollout row through the whole KV-cached decoder and the token head:

  position row t added, layer 0 starts from the normed input; per layer
  LN -> q, k, v (row t of the caches written), self-attention over cache
  rows <= t, o-proj, LN -> cross-attention over the S hoisted slot K/V,
  o-proj, LN -> ReLU FFN of width 4D; final LN, vocabulary logits, argmax
  (first index among ties), dictionary row of the argmax as the next input.

Layouts follow the JAX package where it has one: x ``[B, D]``, caches
``[nb, L, B, D]`` (updated in place), hoisted cross K/V ``[nb, 2, B, S, D]``,
position table ``[L, D]`` float32. The weights are packed for this port's
kernel (``PackedDecoder``): every matrix ``[out, in]`` as ``nn.Linear``
stores it, so one output column is one contiguous row; any vocabulary size,
any row count and any D divisible by the head count are taken.

Rounding points (compute dtype ``dt``, float32 everywhere else): the scaled
q, the K/V row (to the cache dtype, before it is used for position t), the
attention contexts, every LayerNorm output, the FFN hidden; the softmax
weights stay float32 through PV; the residual stream is float32; the next
input is the dictionary row as packed at ``dt``.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from focus_tpu_torch.ops import _build

# wrapper calls that launched the kernels (one per decode step on the card)
LAUNCHES = 0
# device kernels those calls launched, as the C function counted them
DEVICE_LAUNCHES = 0
LN_EPS = 1e-6
MAX_HEAD_DIM = 1024  # the attention kernel's per-lane register budget


class PackedDecoder(NamedTuple):
    """Decoder weights as the step reads them.

    wstack [nb, 14*D*D] at the compute dtype, per layer the row-major
    matrices q|k|v ``[3D, D]``, self o ``[D, D]``, cross q ``[D, D]``,
    cross o ``[D, D]``, fc1 ``[4D, D]``, fc2 ``[D, 4D]``;
    lnp [nb, 6, D] float32 (self, cross, ffn LayerNorm scale and bias);
    bias [nb, 5*D] float32 (fc1's 4D then fc2's D); flnp [2, D] float32;
    head_w [V, D] and dict_w [V, D] at the compute dtype."""

    wstack: torch.Tensor
    lnp: torch.Tensor
    bias: torch.Tensor
    flnp: torch.Tensor
    head_w: torch.Tensor
    dict_w: torch.Tensor


def launches_per_step(num_blocks: int) -> int:
    """Device kernels one step is designed to launch (``DEVICE_LAUNCHES``
    holds what the calls did launch): per layer 3 LayerNorms, 6 skinny
    GEMMs (q|k|v, o, cross q, cross o, fc1, fc2) and 2 attentions; then the
    final LayerNorm, the head GEMM and the argmax/gather."""
    return 11 * num_blocks + 3


@torch.no_grad()
def stack_decoder_params(tf, head, dictionary, dtype=torch.bfloat16):
    """Pack a ``TransformerDecoder`` ``tf``, the token head (``nn.Linear``
    without bias) and the token dictionary (``nn.Embedding``)."""
    ws, lns, biases = [], [], []
    for blk in tf.blocks:
        sa, ca = blk.self_attn, blk.encoder_decoder_attn
        mats = [sa.proj_q.weight, sa.proj_k.weight, sa.proj_v.weight,
                sa.proj_o.weight, ca.proj_q.weight, ca.proj_o.weight,
                blk.ffn[0].weight, blk.ffn[2].weight]
        ws.append(torch.cat([m.to(dtype).reshape(-1) for m in mats]))
        norms = (blk.self_attn_layer_norm, blk.encoder_decoder_attn_layer_norm,
                 blk.ffn_layer_norm)
        lns.append(torch.stack([p for n in norms for p in (n.weight, n.bias)]))
        biases.append(torch.cat([blk.ffn[0].bias, blk.ffn[2].bias]))
    return PackedDecoder(
        torch.stack(ws).contiguous(),
        torch.stack(lns).float().contiguous(),
        torch.stack(biases).float().contiguous(),
        torch.stack([tf.layer_norm.weight, tf.layer_norm.bias]).float()
        .contiguous(),
        head.weight.to(dtype).contiguous(),
        dictionary.weight.to(dtype).contiguous(),
    )


def _ln(x32, gamma, beta):
    m = x32.mean(dim=-1, keepdim=True)
    v = ((x32 - m) ** 2).mean(dim=-1, keepdim=True)
    return (x32 - m) * torch.rsqrt(v + LN_EPS) * gamma + beta


def _mm(a, w):
    """a [B, K] x w [N, K]^T with float32 accumulation -> float32."""
    return torch.matmul(a.float(), w.float().t())


def _attend(q, k, v, heads):
    """q [B, D] (scaled); k, v [B, J, D] -> context [B, D] float32, with a
    float32 softmax over J per head."""
    B, D = q.shape
    J = k.shape[1]
    qh = q.float().reshape(B, heads, 1, D // heads)
    kh = k.float().reshape(B, J, heads, D // heads).permute(0, 2, 1, 3)
    vh = v.float().reshape(B, J, heads, D // heads).permute(0, 2, 1, 3)
    p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)), dim=-1)
    return torch.matmul(p, vh).reshape(B, D)


@torch.no_grad()
def ar_step_reference(x, t, packed, ckv, k_cache, v_cache, pos, heads,
                      logits_out=None):
    """Plain version of ``fused_ar_step``: same arguments and results, the
    same rounding points, float32 accumulation."""
    dt = x.dtype
    B, D = x.shape
    nb = packed.wstack.shape[0]
    t = int(t)
    scale = (D // heads) ** -0.5
    dd = D * D
    xs = _ln(x.float() + pos[t].float(), packed.lnp[0, 0], packed.lnp[0, 1])
    for l in range(nb):
        w = packed.wstack[l]
        lnp, bias = packed.lnp[l], packed.bias[l]
        xn = xs.to(dt) if l == 0 else _ln(xs, lnp[0], lnp[1]).to(dt)
        qkv = _mm(xn, w[:3 * dd].view(3 * D, D))
        q = (qkv[:, :D] * scale).to(dt)
        k_cache[l, t] = qkv[:, D:2 * D].to(k_cache.dtype)
        v_cache[l, t] = qkv[:, 2 * D:].to(v_cache.dtype)
        ctx = _attend(q, k_cache[l, :t + 1].transpose(0, 1),
                      v_cache[l, :t + 1].transpose(0, 1), heads).to(dt)
        xs = xs + _mm(ctx, w[3 * dd:4 * dd].view(D, D))
        xn = _ln(xs, lnp[2], lnp[3]).to(dt)
        q2 = (_mm(xn, w[4 * dd:5 * dd].view(D, D)) * scale).to(dt)
        cctx = _attend(q2, ckv[l, 0], ckv[l, 1], heads).to(dt)
        xs = xs + _mm(cctx, w[5 * dd:6 * dd].view(D, D))
        xn = _ln(xs, lnp[4], lnp[5]).to(dt)
        h = torch.relu(_mm(xn, w[6 * dd:10 * dd].view(4 * D, D))
                       + bias[:4 * D]).to(dt)
        xs = xs + (_mm(h, w[10 * dd:].view(D, 4 * D)) + bias[4 * D:])
    xn = _ln(xs, packed.flnp[0], packed.flnp[1]).to(dt)
    logits = _mm(xn, packed.head_w)
    if logits_out is not None:
        logits_out.copy_(logits)
    ids = torch.argmax(logits, dim=-1)  # first index among ties
    return packed.dict_w[ids], ids.to(torch.int32), k_cache, v_cache


def _workspace_bytes(rows, dim):
    # float32 residual stream; xn, q, ctx and the 4D-wide FFN hidden at bf16
    return rows * dim * (4 + 3 * 2 + 4 * 2)


def workspace(rows, dim, device):
    """Scratch for one step of ``rows`` rollout rows, reusable across
    steps."""
    return torch.empty(_workspace_bytes(rows, dim), dtype=torch.uint8,
                       device=device)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    return _build.bind("ar_decode", "ar_decode_step_bf16",
                       n_ptr=17, n_int=7, n_float=1)


@functools.lru_cache(maxsize=None)
def _step_table(device, length):
    """Step indices in device memory: the kernels read t from there, so one
    launch sequence serves every step."""
    return torch.arange(length, dtype=torch.int32, device=device)


def _launch(x, t, packed, ckv, k_cache, v_cache, pos, heads, logits_out,
            scratch):
    global LAUNCHES, DEVICE_LAUNCHES
    B, D = x.shape
    nb, L = k_cache.shape[0], k_cache.shape[1]
    S, V = ckv.shape[3], packed.head_w.shape[0]
    dev = x.device
    bf16s = (x, packed.wstack, packed.head_w, packed.dict_w, ckv, k_cache,
             v_cache)
    f32s = (packed.lnp, packed.bias, packed.flnp, pos)
    if any(a.dtype != torch.bfloat16 for a in bf16s):
        raise TypeError("the decode-step kernel computes in bfloat16, got "
                        f"{[a.dtype for a in bf16s]}")
    if any(a.dtype != torch.float32 for a in f32s):
        raise TypeError("LayerNorm parameters, biases and the position table "
                        f"must be float32, got {[a.dtype for a in f32s]}")
    if any(a.device != dev or not a.is_contiguous() for a in bf16s + f32s):
        raise ValueError("decode-step operands must be contiguous and on "
                         "one device")
    hd = D // max(heads, 1)
    if heads < 1 or D != heads * hd or hd > MAX_HEAD_DIM:
        raise ValueError(f"D={D} must be heads={heads} x a head dim of at "
                         f"most {MAX_HEAD_DIM}")
    shapes_ok = (
        tuple(packed.wstack.shape) == (nb, 14 * D * D)
        and tuple(packed.lnp.shape) == (nb, 6, D)
        and tuple(packed.bias.shape) == (nb, 5 * D)
        and tuple(packed.flnp.shape) == (2, D)
        and tuple(packed.head_w.shape) == (V, D)
        and tuple(packed.dict_w.shape) == (V, D)
        and tuple(ckv.shape) == (nb, 2, B, S, D) and S >= 1
        and tuple(k_cache.shape) == (nb, L, B, D)
        and tuple(v_cache.shape) == (nb, L, B, D)
        and pos.shape[0] >= L and pos.shape[1] == D
    )
    if not shapes_ok:
        raise ValueError("bad shapes for the decode-step kernel")
    t = int(t)
    if not 0 <= t < L:
        raise ValueError(f"step {t} outside the cache's {L} rows")
    if scratch is None:
        scratch = workspace(B, D, dev)
    elif (scratch.device != dev or scratch.dtype != torch.uint8
          or scratch.numel() < _workspace_bytes(B, D)):
        raise ValueError("workspace too small or on another device")
    if logits_out is None:
        logits_out = torch.empty(B, V, dtype=torch.float32, device=dev)
    elif (logits_out.dtype != torch.float32 or logits_out.device != dev
          or tuple(logits_out.shape) != (B, V)
          or not logits_out.is_contiguous()):
        raise ValueError(f"logits_out must be contiguous float32 [{B}, {V}]")
    next_x = torch.empty(B, D, dtype=torch.bfloat16, device=dev)
    ids = torch.empty(B, dtype=torch.int32, device=dev)
    t_dev = _step_table(dev, L)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn()(
            x.data_ptr(), t_dev.data_ptr() + 4 * t, packed.wstack.data_ptr(),
            packed.lnp.data_ptr(), packed.bias.data_ptr(), ckv.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), packed.flnp.data_ptr(),
            pos.data_ptr(), packed.head_w.data_ptr(),
            packed.dict_w.data_ptr(), next_x.data_ptr(), ids.data_ptr(),
            logits_out.data_ptr(), scratch.data_ptr(),
            ctypes.addressof(launched), B, D, heads, nb, L, S, V, float(hd ** -0.5), stream,
        )
    _build.check(err, "ar_decode_step_bf16")
    LAUNCHES += 1
    DEVICE_LAUNCHES += launched.value
    return next_x, ids, k_cache, v_cache


def fused_ar_step(x, t, packed, ckv, k_cache, v_cache, pos, heads,
                  logits_out=None, scratch=None):
    """One decode step -> (next_x [B, D], ids [B] int32, k_cache, v_cache).

    x [B, D] is the raw token embedding (position row t is added inside);
    t the step index; ``packed`` a ``PackedDecoder``; ckv [nb, 2, B, S, D];
    k_cache / v_cache [nb, L, B, D], row t of every layer written in place;
    pos [L, D] float32. ``logits_out`` (float32 [B, V]) receives the
    vocabulary logits; ``scratch`` is a ``workspace`` to reuse across
    steps. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernels (bf16, contiguous) or raises.
    """
    if x.device.type == "cpu":
        return ar_step_reference(x, t, packed, ckv, k_cache, v_cache, pos,
                                 heads, logits_out)
    if x.device.type != "cuda":
        raise ValueError(f"no decode-step kernel for device {x.device}")
    return _launch(x, t, packed, ckv, k_cache, v_cache, pos, heads,
                   logits_out, scratch)
