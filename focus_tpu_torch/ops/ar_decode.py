"""One fused autoregressive decode step of the STEVE slot rollout: the plain
PyTorch version, the weight packing, and the wrapper of its CUDA kernels
(``csrc/ar_decode.cu``).

Counterpart of ``focus_tpu/ops/pallas/ar_decode.py`` (``fused_ar_step``,
``stack_decoder_params``, ``quantize_wstack``). One step takes the current token embedding of
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

The W8A8 mode (``TPU.INT8_SERVING``; ``quantize_packed`` gives its
``PackedDecoderW8A8``) is the TPU kernel's ``int8=True`` ``mm``: every
product quantizes its A operand per row, s = max(amax, 1e-8) * (1/127),
codes round(a / s), against int8 weight codes with one float32 scale per
output column and JAX chunk, accumulates in int32 and dequantizes as
float(acc) * s_row * s_col. fc2 quantizes the hidden per D-wide group and
adds the dequantized group partials in group order; the next input is the
dequantized dictionary row, which is what the TPU kernel's one-hot W8A8
product gives. LayerNorm, attention and the cache writes are as above.

On the card every kernel of a step is launched with programmatic dependent
launch (PDL), so a kernel's blocks start while the one before it drains
(``csrc/ar_decode.cu``). ``RolloutGraph`` captures a whole rollout of
steps once as a CUDA graph and replays it: the same kernels on the same
operands, with no launch from the host per step.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from focus_tpu_torch.ops import _build

# decode steps run on the card (a wrapper call, or one step of a graph
# replay, counted as many times as the graph is replayed)
LAUNCHES = 0
# device kernels those steps launched, as the C function counted them (for a
# graph, at its capture)
DEVICE_LAUNCHES = 0
# of those, the kernels launched with the PDL attribute
PDL_LAUNCHES = 0
# the same three counts for the W8A8 step
W8A8_LAUNCHES = 0
W8A8_DEVICE_LAUNCHES = 0
W8A8_PDL_LAUNCHES = 0
# replays of captured rollouts (RolloutGraph.run), and captures made
GRAPH_REPLAYS = 0
GRAPH_CAPTURES = 0
LN_EPS = 1e-6
MAX_HEAD_DIM = 1024  # the attention kernel's per-lane register budget
QUANT_EPS = 1e-8
# 1/127 as the TPU kernel multiplies by it; a Python float multiplies a
# float32 tensor as the float32 value it rounds to
INV127 = 1.0 / 127.0


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


class PackedDecoderW8A8(NamedTuple):
    """The W8A8 pack (``quantize_packed``): the matrices of
    ``PackedDecoder`` as int8 codes in the same layout, with float32 scales
    at the TPU kernel's chunk granularity.

    wq [nb, 14*D*D] int8; wscale [nb, 14, D] float32, one row per JAX
    chunk: q, k, v, o, cross q, cross o and the four D-row chunks of fc1
    (one scale per output row over K = D), then fc2's four D-wide K groups
    (scale [10 + j, n] for output row n over k in [jD, (j+1)D));
    head_q [V, D] int8 and head_s [V] float32 (one scale per vocabulary
    row); dict_q [V, D] int8 and dict_s [ceil(V/D), D] float32 (one scale
    per group of D vocabulary rows and output dim; the last group may be
    partial); lnp, bias, flnp as in ``PackedDecoder``."""

    wq: torch.Tensor
    wscale: torch.Tensor
    lnp: torch.Tensor
    bias: torch.Tensor
    flnp: torch.Tensor
    head_q: torch.Tensor
    head_s: torch.Tensor
    dict_q: torch.Tensor
    dict_s: torch.Tensor


def launches_per_step(num_blocks: int, w8a8: bool = False) -> int:
    """Device kernels one step is designed to launch (``DEVICE_LAUNCHES``
    and ``W8A8_DEVICE_LAUNCHES`` hold what the calls did launch): per layer
    3 LayerNorms, 6 skinny GEMMs (q|k|v, o, cross q, cross o, fc1, fc2) and
    2 attentions; then the final LayerNorm, the head GEMM and the
    argmax/gather. The W8A8 step adds 3 row-quantization launches a layer
    (the two attention contexts and the FFN hidden; the LayerNorms
    quantize their own output)."""
    return (14 if w8a8 else 11) * num_blocks + 3


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


def _quantize_chunks(w, K):
    """Codes and scales of ``w`` [R, C] over runs of K consecutive elements
    of a row (the TPU kernel's ``quantize_wstack``: scale max(amax, 1e-8)
    / 127, codes round(w / s), from the values as stored) -> (int8 [R, C],
    float32 [R, C // K])."""
    R, C = w.shape
    w32 = w.float().reshape(R, C // K, K)
    s = w32.abs().amax(dim=-1).clamp_min(QUANT_EPS) / 127.0
    q = torch.round(w32 / s[..., None]).to(torch.int8)
    return q.reshape(R, C), s


@torch.no_grad()
def quantize_packed(packed: PackedDecoder) -> PackedDecoderW8A8:
    """The W8A8 pack of a ``PackedDecoder``, quantized from its values at
    the compute dtype, with the JAX chunk granularity of ``quantize_wstack``
    (the per-layer chunks, and the head and dictionary chunks of its head
    row) carried over to this packing."""
    nb = packed.wstack.shape[0]
    V, D = packed.head_w.shape
    dd = D * D
    wq, ws = [], []
    for l in range(nb):
        w = packed.wstack[l]
        q1, s1 = _quantize_chunks(w[:10 * dd].view(10 * D, D), D)
        q2, s2 = _quantize_chunks(w[10 * dd:].view(D, 4 * D), D)
        wq.append(torch.cat([q1.reshape(-1), q2.reshape(-1)]))
        ws.append(torch.cat([s1.reshape(10, D), s2.t()]))
    head_q, head_s = _quantize_chunks(packed.head_w, D)
    # dictionary chunk j: rows jD..(j+1)D, one scale per output dim
    groups = -(-V // D)
    dict_w = packed.dict_w.float()
    pad = torch.zeros(groups * D - V, D, dtype=dict_w.dtype,
                      device=dict_w.device)
    d3 = torch.cat([dict_w, pad]).view(groups, D, D)
    dict_s = d3.abs().amax(dim=1).clamp_min(QUANT_EPS) / 127.0
    dict_q = torch.round(d3 / dict_s[:, None]).to(torch.int8)
    return PackedDecoderW8A8(
        torch.stack(wq).contiguous(), torch.stack(ws).contiguous(),
        packed.lnp, packed.bias, packed.flnp, head_q.contiguous(),
        head_s.reshape(V).contiguous(), dict_q.reshape(-1, D)[:V].contiguous(),
        dict_s.contiguous())


def next_input(packed, ids, dtype):
    """The next step's input for token ``ids``: the packed dictionary row,
    or for the W8A8 pack its dequantized codes as the TPU kernel's one-hot
    W8A8 product forms them, (float(127 * code) * f32(1/127)) * scale."""
    if isinstance(packed, PackedDecoder):
        return packed.dict_w[ids]
    ids = ids.long()
    D = packed.dict_q.shape[1]
    codes = packed.dict_q[ids].float() * 127.0
    return (codes * INV127 * packed.dict_s[ids // D]).to(dtype)


def _ln(x32, gamma, beta):
    m = x32.mean(dim=-1, keepdim=True)
    v = ((x32 - m) ** 2).mean(dim=-1, keepdim=True)
    return (x32 - m) * torch.rsqrt(v + LN_EPS) * gamma + beta


def _mm(a, w):
    """a [B, K] x w [N, K]^T with float32 accumulation -> float32."""
    return torch.matmul(a.float(), w.float().t())


def _quantize_rows(a):
    """The TPU kernel's activation quantization of ``a`` [B, K]: codes (as
    float, integral) and float32 scales [B, 1], s = max(amax, 1e-8) *
    (1/127) from the values as stored, codes round(a / s)."""
    af = a.float()
    s = af.abs().amax(dim=-1, keepdim=True).clamp_min(QUANT_EPS) * INV127
    return torch.round(af / s), s


def _qmm(a, wq, ws):
    """W8A8 product a [B, K] x wq [N, K]^T with scales ws [N] -> float32:
    the int32 sum is formed exactly (float64 holds these integers), then
    float(acc) * s_row * s_col."""
    codes, s = _quantize_rows(a)
    acc = torch.matmul(codes.double(), wq.double().t())
    return acc.float() * s * ws


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
    same rounding points, float32 accumulation (int32 for the W8A8 pack's
    products)."""
    dt = x.dtype
    B, D = x.shape
    w8a8 = isinstance(packed, PackedDecoderW8A8)
    nb = packed.lnp.shape[0]
    t = int(t)
    scale = (D // heads) ** -0.5
    dd = D * D
    xs = _ln(x.float() + pos[t].float(), packed.lnp[0, 0], packed.lnp[0, 1])
    for l in range(nb):
        lnp, bias = packed.lnp[l], packed.bias[l]
        if w8a8:
            wl, sl = packed.wq[l], packed.wscale[l]

            def mm(a, c0, c1):  # chunks c0..c1-1, each D output rows
                return _qmm(a, wl[c0 * dd:c1 * dd].view(-1, D),
                            sl[c0:c1].reshape(-1))

            def fc2(h):  # each D-wide group dequantized, then summed in order
                w2 = wl[10 * dd:].view(D, 4 * D)
                out = _qmm(h[:, :D], w2[:, :D], sl[10])
                for j in range(1, 4):
                    out = out + _qmm(h[:, j * D:(j + 1) * D],
                                     w2[:, j * D:(j + 1) * D], sl[10 + j])
                return out
        else:
            wl = packed.wstack[l]

            def mm(a, c0, c1):
                return _mm(a, wl[c0 * dd:c1 * dd].view(-1, D))

            def fc2(h):
                return _mm(h, wl[10 * dd:].view(D, 4 * D))
        xn = xs.to(dt) if l == 0 else _ln(xs, lnp[0], lnp[1]).to(dt)
        qkv = mm(xn, 0, 3)
        q = (qkv[:, :D] * scale).to(dt)
        k_cache[l, t] = qkv[:, D:2 * D].to(k_cache.dtype)
        v_cache[l, t] = qkv[:, 2 * D:].to(v_cache.dtype)
        ctx = _attend(q, k_cache[l, :t + 1].transpose(0, 1),
                      v_cache[l, :t + 1].transpose(0, 1), heads).to(dt)
        xs = xs + mm(ctx, 3, 4)
        xn = _ln(xs, lnp[2], lnp[3]).to(dt)
        q2 = (mm(xn, 4, 5) * scale).to(dt)
        cctx = _attend(q2, ckv[l, 0], ckv[l, 1], heads).to(dt)
        xs = xs + mm(cctx, 5, 6)
        xn = _ln(xs, lnp[4], lnp[5]).to(dt)
        h = torch.relu(mm(xn, 6, 10) + bias[:4 * D]).to(dt)
        xs = xs + (fc2(h) + bias[4 * D:])
    xn = _ln(xs, packed.flnp[0], packed.flnp[1]).to(dt)
    if w8a8:
        logits = _qmm(xn, packed.head_q, packed.head_s)
    else:
        logits = _mm(xn, packed.head_w)
    if logits_out is not None:
        logits_out.copy_(logits)
    ids = torch.argmax(logits, dim=-1)  # first index among ties
    return next_input(packed, ids, dt), ids.to(torch.int32), k_cache, v_cache


def _round16(n):
    return (n + 15) // 16 * 16


def _workspace_bytes(rows, dim, w8a8=False):
    # float32 residual stream; xn, q, ctx and the 4D-wide FFN hidden at bf16;
    # W8A8: then the int8 codes of an A operand (up to 4D wide) and its row
    # scales (up to 4 groups), each from a 16-byte boundary
    n = rows * dim * (4 + 3 * 2 + 4 * 2)
    if w8a8:
        n = _round16(n) + _round16(rows * 4 * dim) + rows * 4 * 4
    return n


def workspace(rows, dim, device, w8a8=False):
    """Scratch for one step of ``rows`` rollout rows, reusable across
    steps (``w8a8``: for the W8A8 step)."""
    return torch.empty(_workspace_bytes(rows, dim, w8a8), dtype=torch.uint8,
                       device=device)


@functools.lru_cache(maxsize=None)
def _kernel_fn(w8a8=False):
    if w8a8:
        return _build.bind("ar_decode", "ar_decode_step_w8a8",
                           n_ptr=20, n_int=7, n_float=1)
    return _build.bind("ar_decode", "ar_decode_step_bf16",
                       n_ptr=17, n_int=7, n_float=1)


@functools.lru_cache(maxsize=None)
def _step_table(device, length):
    """Step indices in device memory: the kernels read t from there, so one
    launch sequence serves every step."""
    return torch.arange(length, dtype=torch.int32, device=device)


def _check_operands(x, t, packed, ckv, k_cache, v_cache, pos, heads,
                    logits_out, scratch):
    """The kernels' rules on the operands -> (t, scratch, logits_out, dims);
    raises on a dtype, device, layout or shape they do not take."""
    w8a8 = isinstance(packed, PackedDecoderW8A8)
    B, D = x.shape
    nb, L = k_cache.shape[0], k_cache.shape[1]
    S = ckv.shape[3]
    dev = x.device
    bf16s = (x, ckv, k_cache, v_cache)
    f32s = (packed.lnp, packed.bias, packed.flnp, pos)
    if w8a8:
        V = packed.head_q.shape[0]
        i8s = (packed.wq, packed.head_q, packed.dict_q)
        f32s += (packed.wscale, packed.head_s, packed.dict_s)
        if any(a.dtype != torch.int8 for a in i8s):
            raise TypeError("the W8A8 step takes int8 weight codes, got "
                            f"{[a.dtype for a in i8s]}")
    else:
        V = packed.head_w.shape[0]
        i8s = ()
        bf16s += (packed.wstack, packed.head_w, packed.dict_w)
    if any(a.dtype != torch.bfloat16 for a in bf16s):
        raise TypeError("the decode-step kernel computes in bfloat16, got "
                        f"{[a.dtype for a in bf16s]}")
    if any(a.dtype != torch.float32 for a in f32s):
        raise TypeError("LayerNorm parameters, biases, scales and the "
                        "position table must be float32, got "
                        f"{[a.dtype for a in f32s]}")
    if any(a.device != dev or not a.is_contiguous()
           for a in bf16s + f32s + i8s):
        raise ValueError("decode-step operands must be contiguous and on "
                         "one device")
    hd = D // max(heads, 1)
    if heads < 1 or D != heads * hd or hd > MAX_HEAD_DIM:
        raise ValueError(f"D={D} must be heads={heads} x a head dim of at "
                         f"most {MAX_HEAD_DIM}")
    if w8a8:
        weights_ok = (
            tuple(packed.wq.shape) == (nb, 14 * D * D)
            and tuple(packed.wscale.shape) == (nb, 14, D)
            and tuple(packed.head_q.shape) == (V, D)
            and tuple(packed.head_s.shape) == (V,)
            and tuple(packed.dict_q.shape) == (V, D)
            and tuple(packed.dict_s.shape) == (-(-V // D), D))
    else:
        weights_ok = (
            tuple(packed.wstack.shape) == (nb, 14 * D * D)
            and tuple(packed.head_w.shape) == (V, D)
            and tuple(packed.dict_w.shape) == (V, D))
    shapes_ok = (
        weights_ok
        and tuple(packed.lnp.shape) == (nb, 6, D)
        and tuple(packed.bias.shape) == (nb, 5 * D)
        and tuple(packed.flnp.shape) == (2, D)
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
        scratch = workspace(B, D, dev, w8a8)
    elif (scratch.device != dev or scratch.dtype != torch.uint8
          or scratch.numel() < _workspace_bytes(B, D, w8a8)):
        raise ValueError("workspace too small or on another device")
    if logits_out is None:
        logits_out = torch.empty(B, V, dtype=torch.float32, device=dev)
    elif (logits_out.dtype != torch.float32 or logits_out.device != dev
          or tuple(logits_out.shape) != (B, V)
          or not logits_out.is_contiguous()):
        raise ValueError(f"logits_out must be contiguous float32 [{B}, {V}]")
    return t, scratch, logits_out, (B, D, heads, nb, L, S, V)


def _count(w8a8, steps, kernels, pdl):
    global LAUNCHES, DEVICE_LAUNCHES, PDL_LAUNCHES
    global W8A8_LAUNCHES, W8A8_DEVICE_LAUNCHES, W8A8_PDL_LAUNCHES
    if w8a8:
        W8A8_LAUNCHES += steps
        W8A8_DEVICE_LAUNCHES += kernels
        W8A8_PDL_LAUNCHES += pdl
    else:
        LAUNCHES += steps
        DEVICE_LAUNCHES += kernels
        PDL_LAUNCHES += pdl


def _call(x, t, packed, ckv, k_cache, v_cache, pos, heads, logits_out,
          scratch, next_x, ids, dims):
    """One step's kernels on the current stream, on checked operands, into
    ``next_x`` and ``ids``; nothing allocated, nothing counted. Returns
    (device kernels launched, of them with the PDL attribute)."""
    w8a8 = isinstance(packed, PackedDecoderW8A8)
    D, L = dims[1], dims[4]
    dev = x.device
    t_dev = _step_table(dev, L)
    if w8a8:
        weights = (packed.wq, packed.wscale, packed.lnp, packed.bias)
        head = (packed.head_q, packed.head_s, packed.dict_q, packed.dict_s)
        name = "ar_decode_step_w8a8"
    else:
        weights = (packed.wstack, packed.lnp, packed.bias)
        head = (packed.head_w, packed.dict_w)
        name = "ar_decode_step_bf16"
    launched = (ctypes.c_int * 2)(0, 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn(w8a8)(
            x.data_ptr(), t_dev.data_ptr() + 4 * t,
            *[a.data_ptr() for a in weights], ckv.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), packed.flnp.data_ptr(),
            pos.data_ptr(), *[a.data_ptr() for a in head],
            next_x.data_ptr(), ids.data_ptr(), logits_out.data_ptr(),
            scratch.data_ptr(), ctypes.addressof(launched), *dims,
            float((D // heads) ** -0.5), stream,
        )
    _build.check(err, name)
    return launched[0], launched[1]


def _launch(x, t, packed, ckv, k_cache, v_cache, pos, heads, logits_out,
            scratch):
    t, scratch, logits_out, dims = _check_operands(
        x, t, packed, ckv, k_cache, v_cache, pos, heads, logits_out, scratch)
    B, D = dims[0], dims[1]
    next_x = torch.empty(B, D, dtype=torch.bfloat16, device=x.device)
    ids = torch.empty(B, dtype=torch.int32, device=x.device)
    kernels, pdl = _call(x, t, packed, ckv, k_cache, v_cache, pos, heads,
                         logits_out, scratch, next_x, ids, dims)
    _count(isinstance(packed, PackedDecoderW8A8), 1, kernels, pdl)
    return next_x, ids, k_cache, v_cache


def fused_ar_step(x, t, packed, ckv, k_cache, v_cache, pos, heads,
                  logits_out=None, scratch=None):
    """One decode step -> (next_x [B, D], ids [B] int32, k_cache, v_cache).

    x [B, D] is the raw token embedding (position row t is added inside);
    t the step index; ``packed`` a ``PackedDecoder``, or a
    ``PackedDecoderW8A8`` for the W8A8 step; ckv [nb, 2, B, S, D];
    k_cache / v_cache [nb, L, B, D], row t of every layer written in place;
    pos [L, D] float32. ``logits_out`` (float32 [B, V]) receives the
    vocabulary logits; ``scratch`` is a ``workspace`` to reuse across
    steps. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernels (bf16 activations, contiguous) or raises. The bf16 step counts
    into ``LAUNCHES``, ``DEVICE_LAUNCHES`` and ``PDL_LAUNCHES``, the W8A8
    step into the ``W8A8_`` three.
    """
    if x.device.type == "cpu":
        return ar_step_reference(x, t, packed, ckv, k_cache, v_cache, pos,
                                 heads, logits_out)
    if x.device.type != "cuda":
        raise ValueError(f"no decode-step kernel for device {x.device}")
    return _launch(x, t, packed, ckv, k_cache, v_cache, pos, heads,
                   logits_out, scratch)


def rollout_graph_key(rows, w8a8, gen_len, dtype, with_logits):
    """What a captured rollout is kept under: its rows, mode, length and
    dtype, and whether it writes every step's logits."""
    return (int(rows), bool(w8a8), int(gen_len), dtype, bool(with_logits))


def rollout_buffers(packed, rows, dim, slots, gen_len, with_logits,
                    dtype=torch.bfloat16):
    """The static buffers a ``RolloutGraph`` owns, name -> (shape, dtype):
    the token ping-pong (step t reads x[t % 2] and writes x[(t + 1) % 2]),
    the caches of L = gen_len + 1 rows, the hoisted cross K/V, the position
    table, every step's ids, and the logits (every step's, or one step's
    that the next overwrites)."""
    nb = packed.lnp.shape[0]
    w8a8 = isinstance(packed, PackedDecoderW8A8)
    V = (packed.head_q if w8a8 else packed.head_w).shape[0]
    L = gen_len + 1
    return {
        "x": ((2, rows, dim), dtype),
        "k_cache": ((nb, L, rows, dim), dtype),
        "v_cache": ((nb, L, rows, dim), dtype),
        "ckv": ((nb, 2, rows, slots, dim), dtype),
        "pos": ((L, dim), torch.float32),
        "ids": ((gen_len, rows), torch.int32),
        "logits": ((gen_len if with_logits else 1, rows, V), torch.float32),
    }


class RolloutGraph:
    """A whole rollout of ``gen_len`` fused steps, captured once as one CUDA
    graph into static buffers (``rollout_buffers``) and replayed per
    rollout: the same kernels on the same operands as ``gen_len`` calls of
    ``fused_ar_step``, so the ids and logits are bit-equal to theirs, with
    no host work between steps. The step index of step t is row t of the
    device step table, a constant of the graph; cache rows past t are never
    read before step t writes them, so the caches need no reset between
    replays. The weights' pack is part of the graph: a new pack needs a new
    capture. A capture that fails raises; nothing falls back to per-step
    launches."""

    def __init__(self, packed, heads, rows, dim, slots, gen_len, device,
                 with_logits=False, dtype=torch.bfloat16):
        global GRAPH_CAPTURES
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a rollout graph runs on CUDA, not {device}")
        self.packed, self.gen_len = packed, gen_len
        self.w8a8 = isinstance(packed, PackedDecoderW8A8)
        self.with_logits = with_logits
        for name, (shape, dt) in rollout_buffers(
                packed, rows, dim, slots, gen_len, with_logits, dtype).items():
            setattr(self, name, torch.zeros(shape, dtype=dt, device=device))
        self.scratch = workspace(rows, dim, device, self.w8a8)
        x, ids, logits = self.x, self.ids, self.logits
        _, _, _, dims = _check_operands(
            x[0], 0, packed, self.ckv, self.k_cache, self.v_cache, self.pos,
            heads, logits[0], self.scratch)
        _step_table(x.device, dims[4])  # before the capture, not in its pool

        def step(t):
            return _call(x[t % 2], t, packed, self.ckv, self.k_cache,
                         self.v_cache, self.pos, heads,
                         logits[t if with_logits else 0], self.scratch,
                         x[(t + 1) % 2], ids[t], dims)

        # one step outside the capture first: the kernels' lazily set
        # attributes are set there, not inside it
        with torch.cuda.device(device):
            _count(self.w8a8, 1, *step(0))
            torch.cuda.synchronize(device)
            self.graph = torch.cuda.CUDAGraph()
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            kernels = pdl = 0
            with torch.cuda.graph(self.graph, stream=stream):
                for t in range(gen_len):
                    k, p = step(t)
                    kernels, pdl = kernels + k, pdl + p
            torch.cuda.current_stream(device).wait_stream(stream)
        self.kernels, self.pdl_kernels = kernels, pdl
        GRAPH_CAPTURES += 1

    def run(self, x0, ckv, pos, logits=None):
        """Replay the rollout from the first token ``x0`` [B, D], the
        hoisted cross K/V ``ckv`` and the position table ``pos`` (at least
        L rows); ``logits`` (float32 [gen_len, B, V]) receives every step's
        logits where the graph was captured with them. Returns the ids
        [gen_len, B] int32 (a new tensor)."""
        global GRAPH_REPLAYS
        if (logits is not None) != self.with_logits:
            raise ValueError("logits are written by a graph captured with "
                             "with_logits=True, and only by it")
        self.x[0].copy_(x0)
        self.ckv.copy_(ckv)
        self.pos.copy_(pos[:self.pos.shape[0]])
        self.graph.replay()
        GRAPH_REPLAYS += 1
        _count(self.w8a8, self.gen_len, self.kernels, self.pdl_kernels)
        if logits is not None:
            logits.copy_(self.logits)
        return self.ids.clone()
