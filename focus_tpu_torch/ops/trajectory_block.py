"""Fused trajectory-attention core for the non-CLS tokens: the plain
PyTorch versions of its forward and backward, and the wrappers of their
CUDA kernels (``csrc/trajectory_block.cu``, ``csrc/trajectory_block_bwd.cu``
and the other forward versions) joined by a ``torch.autograd.Function``.

Counterpart of ``focus_tpu/ops/pallas/trajectory_block.py``
(``fused_trajectory_core``, its ``_xla_reference`` and its custom VJP
``_fused_bwd``), with the JAX signature and layout: q ``[B, S, C]``, kf/vf
``[B, F, N, C]``, Wq2/Wk2 ``[C, C]`` as ``[in, out]``, bq2/bk2 ``[C]``;
S = F * N. Semantics follow reference ``slowfast/models/attention.py:499-557``
with ``use_original_code=True``.

Forward versions: the module constant ``FWD_VERSION``, read at each call as
the JAX package reads its own, picks the forward kernel on the card. 4 (the
default) is ``csrc/trajectory_block.cu``, three launches; 3 and 7 are the
same source's three launches in its rounding mode V3 (``traj_core_v3_bf16``
and ``traj_core_v7_bf16``), the same function rounded as the TPU kernels v3
and v7 round it: those two kernels differ in their arrangement for the TPU
alone, so on this card one design serves both; 5 and 6 compute the stage-2
logits through ``k2v = V . Wk2`` as the TPU kernels v5 and v6 do
(``csrc/trajectory_block_v5.cu``, which never forms the per-frame
aggregates xs, and ``csrc/trajectory_block_v6.cu``, which does: one design
with a flag, ``csrc/trajectory_k2v.cuh``, four launches), which equals
version 4 only where every head's stage-1 weights agree: elsewhere they
compute another function. Every
version has the same backward kernel, which reads xs and q2: v3, v6 and v7
write them as version 4 does, v5 recomputes them with the version-4 kernel
first. CPU tensors take ``trajectory_core_reference`` at every version, as
the JAX package takes its XLA composition off the TPU;
``trajectory_core_v3_reference`` (also ``trajectory_core_v7_reference``),
``trajectory_core_v5_reference`` and ``trajectory_core_v6_reference``
follow the TPU kernels step by step, and ``trajectory_core_v3_mirror``,
``trajectory_core_k2v_mirror`` and ``trajectory_core_chunked_mirror`` the
card's kernels 3 / 4, 5 / 6 and kernel 1 at N > 256.

Keys a frame: every forward kernel and the backward kernel take N <= 512
(the 336 crop's 441 and 445) and refuse 513 before any build, so every
version trains there. Past 256 the stage 1 of kernels 1, 3 and 4 and the
own-frame launch of kernels 5 and 6 run in the chunked form of
``csrc/space_stage_core.cuh`` (two chunks of ``chunk_keys`` keys a frame,
the softmax online across them, the weights rounded unnormalised), the
pass of kernels 5 and 6 in its own chunked form (``k2v_pass_plan``), and
the backward's dq kernel in its own, ``stage1_dq_chunked_kernel``.

Float32 operands on the card: the kernels take bf16 alone, so a CUDA call
with a float32 operand (the ``TPU.COMPUTE_DTYPE: float32`` case, which the
JAX kernel serves in float32) raises ``TypeError``: the kernels' float32
mode is open (ROADMAP.md section 2 A2). Nothing on the card falls back to
the plain version.
"""

import ctypes
import functools

import torch

from focus_tpu_torch.ops import _build
from focus_tpu_torch.ops import attention as attn_ops
from focus_tpu_torch.ops import trajectory_attention as ta
# the stage-1 kernel's chunked form past MAX_KEYS keys a frame, shared with
# kernel 8 (csrc/space_stage_core.cuh)
from focus_tpu_torch.ops.trajectory_attention import (
    MAX_KEYS_CHUNKED,
    STAGE1_CHUNKS,
    chunk_keys,
)

# forward kernel launches since the last reset (one per wrapper call on the
# card); BWD_LAUNCHES counts backward wrapper calls and BWD_DEVICE_LAUNCHES
# the device kernels those calls launched, as the C function counts them
LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_DEVICE_LAUNCHES = 0
# the v3, v5, v6 and v7 forward kernels: wrapper calls, and the device
# kernels those calls launched (three per v3 or v7 call: stage 1, the q2
# GEMM and stage 2; four per v5 or v6 call: the k2v GEMM, the own-frame
# aggregates, the q2 GEMM and the pass)
V3_LAUNCHES = V3_DEVICE_LAUNCHES = 0
V5_LAUNCHES = V5_DEVICE_LAUNCHES = 0
V6_LAUNCHES = V6_DEVICE_LAUNCHES = 0
V7_LAUNCHES = V7_DEVICE_LAUNCHES = 0

# forward kernel on the card: 4 (csrc/trajectory_block.cu), 3, 5, 6 or 7
FWD_VERSION = 4
PORTED_FWD_VERSIONS = (3, 4, 5, 6, 7)

HEAD_DIM = 64  # the kernels' head dim; also C % 128 == 0, F <= 8, heads <= 16
# keys a frame in one pass; past it (up to MAX_KEYS_CHUNKED) two chunks
MAX_KEYS = 256


def trajectory_core_stage1_reference(q, kf, vf, wq2, bq2, scale, heads):
    """The plain version's first half -> (xs [B, S, F, C], q2 [B, S, C]) at
    q's dtype: stage 1 (``space_stage``) per head, the diagonal, and q2 =
    x_diag . Wq2 + bq2, the two tensors the forward kernel writes on the
    way and the backward reads."""
    B, S, C = q.shape
    F, N = kf.shape[1], kf.shape[2]
    hd = C // heads

    def split(t):
        return t.reshape(B, -1, heads, hd).permute(0, 2, 1, 3).reshape(
            B * heads, -1, hd
        )

    xs = attn_ops.space_stage(
        split(q), split(kf.reshape(B, F * N, C)), split(vf.reshape(B, F * N, C)),
        F, scale,
    )  # [BH, S, F, hd]
    xs = xs.reshape(B, heads, S, F, hd).permute(0, 2, 3, 1, 4).reshape(
        B, S, F, C
    )
    x_diag = attn_ops.take_diagonal(xs, F)
    q2 = torch.matmul(x_diag.float(), wq2.to(q.dtype).float()).to(q.dtype)
    return xs, q2 + bq2.to(q.dtype)


def trajectory_core_reference(q, kf, vf, wq2, bq2, wk2, bk2, scale, heads):
    """Plain version: stage 1 (``space_stage``), the diagonal, q2, then
    stage 2 with the k2 projection on the query side
    (``temporal_stage_k2w``). bk2 is constant over frames and drops out."""
    del bk2
    F = kf.shape[1]
    xs, q2 = trajectory_core_stage1_reference(q, kf, vf, wq2, bq2, scale,
                                              heads)
    return attn_ops.temporal_stage_k2w(q2, wk2, xs, F, scale, heads)


# kernel 1's launch plan (csrc/trajectory_block.cu; its stage 1 is the
# space stage's kernel, csrc/space_stage_core.cuh), and kernels 3 and 4's,
# the same launches in the rounding mode V3
GEMM_TILE = 128        # the q2 GEMM's output tiles (trajectory_core.cuh)
STAGE2_ROWS = (64, 48)  # rows a stage-2 block: 64, or 48 where it takes fewer waves x rows
STAGE2_WARPS = 16      # one head a warp for g (heads <= 16)
STAGE2_CHANNELS = 16   # xs and Wk2 channels a chunk
STAGE2_MAX_STAGES = 3  # chunks in flight, where they fit
SMEM_LIMIT = 232_448
MAX_FRAMES, MAX_HEADS = 8, 16


def _stage2_bytes(heads, rows, v3=False):
    """(g line length in bf16, bytes of one ring slot, fixed bytes, ring
    slots) of a stage-2 block, as
    ``csrc/trajectory_block.cu`` computes them: a (row, head) line of g
    holds the chunk's 16 channels and 8 of padding, in the mode V3 its 16
    hi values, 16 lo values and the padding."""
    line = STAGE2_CHANNELS * (2 if v3 else 1) + 8
    g_ld = heads * line + (0 if heads % 2 else 8)
    g_bytes = -(-rows * g_ld * 2 // 16) * 16
    stage_bytes = (heads * STAGE2_CHANNELS * HEAD_DIM * 2
                   + rows * MAX_FRAMES * STAGE2_CHANNELS * 2)
    fixed = 1024 + 2 * g_bytes + 16 + 64
    stages = min(STAGE2_MAX_STAGES, (SMEM_LIMIT - fixed) // stage_bytes)
    return line, stage_bytes, fixed, stages


def stage2_rows(M, sms=132, heads=12, v3=False):
    """Rows a stage-2 block for M rows on ``sms`` SMs (one block an SM), as
    ``s2_rows`` picks them: 48 where waves x rows is smaller than with 64;
    in the mode V3 (``s2_rows_v3``) also 48 where 64 rows of ``heads``
    heads leave fewer than two ring slots."""
    if v3 and _stage2_bytes(heads, 64, True)[3] < 2:
        return 48
    waves = {r: -(-(-(-M // r)) // sms) for r in STAGE2_ROWS}
    return 48 if waves[48] * 48 < waves[64] * 64 else 64


def trajectory_core_plan(B, S, F, N, heads, sms=132, v3=False):
    """Kernel 1's launch plan, as ``csrc/trajectory_block.cu`` computes it,
    or with ``v3`` kernels 3 and 4's (the same launches in the rounding
    mode V3): stage 1 as the space stage plans it for B x heads head rows
    (``trajectory_attention.space_stage_plan``; at N > 256 its chunked
    form, ``trajectory_attention.chunked_stage1_plan``, in both roundings);
    the q2 GEMM's tiles (in V3 it also writes the scaled stage-2 query into
    out); and stage 2's
    blocks of 48 or 64 rows with every head (one warp a head forms g), its
    ring of 16-channel chunks fed by TMA, its two g buffers (V3: hi and lo
    in each line), shared memory and waves, and the number of blocks that
    read a row block's xs for the logits (one: every head's logits come
    from the same block). Raises ``ValueError`` where the kernel takes no
    such shape."""
    C = heads * HEAD_DIM
    if not (1 <= heads <= MAX_HEADS and C % 128 == 0 and 1 <= F <= MAX_FRAMES
            and S == F * N and B >= 1):
        raise ValueError(f"trajectory kernel needs C % 128 == 0, heads <= "
                         f"{MAX_HEADS}, F <= {MAX_FRAMES}, S = F N (B={B}, "
                         f"S={S}, F={F}, N={N}, heads={heads})")
    stage1 = ta.space_stage_plan(B * heads, S, F, N, sms)
    M = B * S
    rows = stage2_rows(M, sms, heads, v3)
    line, stage_bytes, fixed, stages = _stage2_bytes(heads, rows, v3)
    blocks = -(-M // rows)
    stage2 = {
        "rows_per_block": rows, "blocks": blocks, "waves": -(-blocks // sms),
        "threads": 32 * STAGE2_WARPS, "g_warps": heads,
        "heads_per_block": heads, "chunk_channels": STAGE2_CHANNELS,
        "chunks": C // STAGE2_CHANNELS, "stages": stages, "g_buffers": 2,
        "g_line": line, "g_parts": 2 if v3 else 1,
        "logit_mma_per_row_chunk": 2 if v3 else 1,
        "stage_bytes": stage_bytes, "smem_bytes": fixed + stages * stage_bytes,
        "xs_logit_reads_per_row_block": 1,
        "a2_bytes": rows * MAX_HEADS * MAX_FRAMES * 4,
        "ring_bytes": stages * stage_bytes,
    }
    gemm = {"grid": (-(-C // GEMM_TILE), -(-M // GEMM_TILE)), "threads": 256,
            "outputs": 2 if v3 else 1}
    return {"stage1": stage1, "gemm": gemm, "stage2": stage2, "rows": M,
            "channels": C, "rounding": "v3" if v3 else "v4",
            "device_launches": 3}


def check_fwd_version(version=None):
    """``version`` (default: ``FWD_VERSION``) if the port has its kernel,
    else NotImplementedError."""
    version = FWD_VERSION if version is None else version
    if version not in PORTED_FWD_VERSIONS:
        raise NotImplementedError(
            f"trajectory-core FWD_VERSION={version!r}: the port has the "
            f"forward kernels {PORTED_FWD_VERSIONS} and no other")
    return version


def _stage1_weights(q, kf, vf, scale, heads):
    """The stage-1 pieces v3, v5 and v6 share, in float32 from operands at
    q's dtype: the head-split v, the unnormalised weights p = exp(logit -
    max) with a true max per frame (the TPU kernels clamp exp2 with no max
    instead) and the per-frame sums s."""
    B, S, C = q.shape
    F, N = kf.shape[1], kf.shape[2]
    hd = C // heads
    qh = q.float().reshape(B, S, heads, hd).permute(0, 2, 1, 3)
    kh = kf.float().reshape(B, F, N, heads, hd).permute(0, 3, 1, 2, 4)
    vh = vf.float().reshape(B, F, N, heads, hd).permute(0, 3, 1, 2, 4)
    logits = torch.einsum("bhsd,bhfnd->bhsfn", qh, kh) * scale
    p = torch.exp(logits - logits.amax(-1, keepdim=True))  # [B, h, S, F, N]
    return vh, p, p.sum(-1)  # s: [B, h, S, F]


def _variant_stage1(q, kf, vf, wk2, scale, heads):
    """The pieces v5 and v6 share: ``_stage1_weights`` and k2v = V . Wk2
    rounded to q's dtype as the kernels keep it, split by head."""
    B, S, C = q.shape
    F, N = kf.shape[1], kf.shape[2]
    hd, dt = C // heads, q.dtype
    vh, p, s = _stage1_weights(q, kf, vf, scale, heads)
    k2v = (vf.float().reshape(B, F * N, C) @ wk2.to(dt).float()).to(dt)
    k2vh = k2v.float().reshape(B, F, N, heads, hd).permute(0, 3, 1, 2, 4)
    return vh, p, s, k2vh


def _variant_a2(x_diag, wq2, bq2, p, s, k2vh, scale, heads):
    """q2 = x_diag . Wq2 + bq2 (rounded to x_diag's dtype); per head h
    M_h = q2_h . k2v_h^T and the stage-2 logits l2_h[f] = sum_{n in f}
    p_h M_h / s_h[f] * scale; returns a2 = softmax_f(l2) in float32.
    l2_h is q2_h . (xs_f . Wk2)_h only where every head's stage-1 weights
    equal head h's: xs_f's channels of head h' carry head h' weights, and
    Wk2 mixes all channels into every head (``csrc/trajectory_k2v.cuh``)."""
    B, S, C = x_diag.shape
    dt = x_diag.dtype
    q2 = (x_diag.float() @ wq2.to(dt).float() + bq2.to(dt).float()).to(dt)
    q2h = q2.float().reshape(B, S, heads, C // heads).permute(0, 2, 1, 3)
    m = torch.einsum("bhsd,bhfnd->bhsfn", q2h, k2vh)
    l2 = (p * m).sum(-1) / s * scale
    return torch.softmax(l2, dim=-1)


def _v3_xs(q, kf, vf, scale, heads):
    """xs [B, S, F, C] at q's dtype as v3 and v7 form it: per frame and
    head round(round(p_f) . V_f / s_f), the weights rounded before they are
    normalised and s_f the float32 sum of the unrounded weights."""
    B, S, C = q.shape
    F = kf.shape[1]
    vh, p, s = _stage1_weights(q, kf, vf, scale, heads)
    o = torch.einsum("bhsfn,bhfnd->bhsfd", p.to(q.dtype).float(), vh)
    return (o / s[..., None]).to(q.dtype).permute(0, 2, 3, 1, 4).reshape(
        B, S, F, C)


def trajectory_core_v3_stage1_reference(q, kf, vf, wq2, bq2, scale, heads):
    """The v3 / v7 plain version's first half -> (xs [B, S, F, C], q2
    [B, S, C]) at q's dtype, the two tensors kernels 3 and 4 write for the
    backward: xs as ``_v3_xs`` forms it and q2 = round(x_diag . Wq2 + bq2),
    unscaled."""
    dt = q.dtype
    xs = _v3_xs(q, kf, vf, scale, heads)
    x_diag = attn_ops.take_diagonal(xs, kf.shape[1])
    q2 = x_diag.float() @ wq2.to(dt).float() + bq2.to(dt).float()
    return xs, q2.to(dt)


def trajectory_core_v3_reference(q, kf, vf, wq2, bq2, wk2, bk2, scale,
                                 heads):
    """Plain version of the v3 and v7 kernels, step by step (TPU
    ``_fused_kernel_v3`` under its ``KERNEL_FLAGS`` and ``_fused_kernel_v7``,
    which round at the same points and differ in arrangement alone): stage 1
    per frame and head with the weights rounded before they are normalised,
    s_f the float32 sum of the unrounded weights, xs_f = round(round(p_f) .
    V_f / s_f); x_diag; q2 = (x_diag . Wq2 + bq2) * scale in float32; per
    head g_h = round(q2_h) . Wk2_h^T left in float32, the stage-2 logits
    l2[f] = g_h . xs_f, a2 = softmax over frames (float32); out = sum_f a2_f
    xs_f rounded once. The function of ``trajectory_core_reference``,
    rounded at other points (version 4 normalises the weights before it
    rounds them, and rounds q2 and g). Float32 arithmetic with the kernels'
    rounding points (q's dtype); bk2 drops out."""
    del bk2
    B, S, C = q.shape
    F = kf.shape[1]
    hd, dt = C // heads, q.dtype
    xs = _v3_xs(q, kf, vf, scale, heads)
    x_diag = attn_ops.take_diagonal(xs, F)
    q2 = (x_diag.float() @ wq2.to(dt).float() + bq2.float()) * scale
    g = torch.einsum("bshd,chd->bshc", q2.to(dt).float().reshape(
        B, S, heads, hd), wk2.float().reshape(C, heads, hd))
    xsf = xs.float()
    a2 = torch.softmax(torch.einsum("bshc,bsfc->bshf", g, xsf), dim=-1)
    out = torch.einsum("bshf,bsfhd->bshd", a2,
                       xsf.reshape(B, S, F, heads, hd))
    return out.to(dt).reshape(B, S, C)


def _chunked_stage1(q, kf, values, scale, heads):
    """The chunked stage 1 (``trajectory_attention.chunked_stage1_sums``)
    per head of q [B, S, C] and kf [B, F, N, C], for each of ``values``
    ([B, F, N, C]) its frame sums times 1 / l in float32, [B, heads, S, F,
    hd]."""
    B, S, C = q.shape
    F = kf.shape[1]
    hd = C // heads

    def rows(t):  # [B, ..., C] -> [B heads, ..., hd]
        lead = t.shape[1:-1]
        return t.reshape(B, *lead, heads, hd).movedim(-2, 1).reshape(
            B * heads, *lead, hd)

    sums = ta.chunked_stage1_sums(rows(q), rows(kf),
                                  [rows(v) for v in values], scale)
    return [a.reshape(B, heads, S, F, hd) for a in sums]


def _chunked_xs(q, kf, vf, scale, heads):
    """xs [B, S, F, C] at q's dtype as the chunked stage 1 forms it
    (kernels 1, 3 and 4 at N > 256): round(o * (1 / l)) per head."""
    B, S, C = q.shape
    o, = _chunked_stage1(q, kf, [vf], scale, heads)
    return o.to(q.dtype).permute(0, 2, 3, 1, 4).reshape(B, S, kf.shape[1], C)


def trajectory_core_chunked_mirror(q, kf, vf, wq2, bq2, wk2, bk2, scale,
                                   heads, intermediates=None):
    """Plain mirror of kernel 1 at N > 256 (``csrc/space_stage_core.cuh``
    in its chunked form): its steps and rounding points, in float32
    arithmetic on operands at q's dtype. Stage 1 per frame and head over
    the frame's keys in two chunks (``chunk_keys``), the softmax online
    across them (``trajectory_attention.chunked_stage1_sums``): chunk 0's
    row max m0, p0 = exp(logit * scale - m0 * scale), l = sum p0, o =
    round(p0) . V_0; chunk 1 raises the max to m1, scales l and o by
    exp((m0 - m1) * scale) and adds its own p1 = exp(logit * scale - m1 *
    scale) and round(p1) . V_1; xs = round(o * (1 / l)). The weights are
    rounded unnormalised, as in the mode V3, where kernel 1 at N <= 256
    normalises them first. Then as kernel 1 at any N: q2 = round(x_diag .
    Wq2 + bq2) and stage 2 (``temporal_stage_k2w``). Returns out; a dict
    passed as ``intermediates`` receives xs and q2. Nothing on the card
    calls it.

    Against the plain version in float32 on the same bf16 operands (B=1,
    F=8, 2 heads; tests/test_torch_port_hr336.py) out differs by 4.6e-3,
    4.4e-3 and 4.4e-3 x max|ref| at N = 257, 441 and 512 on the CPU, as
    near as the plain version in bf16 (4.0e-3 to 4.8e-3), within half
    the card's 2e-2 gate."""
    del bk2
    F = kf.shape[1]
    dt = q.dtype
    xs = _chunked_xs(q, kf, vf, scale, heads)
    x_diag = attn_ops.take_diagonal(xs, F)
    q2 = (x_diag.float() @ wq2.to(dt).float() + bq2.to(dt).float()).to(dt)
    if intermediates is not None:
        intermediates.update(xs=xs, q2=q2)
    return attn_ops.temporal_stage_k2w(q2, wk2, xs, F, scale, heads)


def trajectory_core_v3_mirror(q, kf, vf, wq2, bq2, wk2, bk2, scale, heads,
                              intermediates=None):
    """Plain mirror of kernels 3 and 4 on the card (``csrc/trajectory_block.cu``
    in its rounding mode V3): their steps and rounding points, in float32
    arithmetic on operands at q's dtype. Stage 1 (``space_stage_core.cuh``):
    p = exp(logit * scale - max) rounded unnormalised, s the float32 sum of
    the unrounded p, xs = round((round(p) . V) * (1 / s)); at N > 256 the
    chunked form's, ``trajectory_core_chunked_mirror``'s (the same rounding
    but for chunk 0's weights, rounded against chunk 0's max and rescaled
    in float32 after the product). The q2 GEMM: q2 =
    round(x_diag . Wq2 + bq2) for the backward and the stage-2 query qs =
    round((x_diag . Wq2 + bq2) * scale). Stage 2 chunk by chunk of 16
    channels: g_h = qs_h . Wk2_h^T in float32, split as hi = round(g) and
    lo = round(g - hi); the logits add hi . xs_f, then lo . xs_f; a2 =
    softmax over frames, float32 and unrounded; out = round(sum_f a2_f
    xs_f). Returns out; a dict passed as ``intermediates`` receives xs, q2,
    qs, g, g_hi, g_lo, logits and a2. Nothing on the card calls it."""
    del bk2
    B, S, C = q.shape
    F = kf.shape[1]
    hd, dt = C // heads, q.dtype

    def rnd(t):
        return t.to(dt).float()

    if kf.shape[2] > MAX_KEYS:
        xs = _chunked_xs(q, kf, vf, scale, heads)
    else:
        vh, p, s = _stage1_weights(q, kf, vf, scale, heads)
        o = torch.einsum("bhsfn,bhfnd->bhsfd", rnd(p), vh)
        xs = (o * (1 / s)[..., None]).to(dt).permute(0, 2, 3, 1, 4).reshape(
            B, S, F, C)
    x_diag = attn_ops.take_diagonal(xs, F)
    acc = x_diag.float() @ wq2.to(dt).float() + bq2.to(dt).float()
    q2, qs = acc.to(dt), rnd(acc * scale)
    g = torch.einsum("bshd,chd->bshc", qs.reshape(B, S, heads, hd),
                     wk2.to(dt).float().reshape(C, heads, hd))
    hi = rnd(g)
    lo = rnd(g - hi)
    xsf = xs.float()
    logits = torch.zeros(B, S, heads, F, dtype=torch.float32, device=q.device)
    for c0 in range(0, C, STAGE2_CHANNELS):
        ch = slice(c0, c0 + STAGE2_CHANNELS)
        logits = logits + torch.einsum("bshc,bsfc->bshf", hi[..., ch],
                                       xsf[..., ch])
        logits = logits + torch.einsum("bshc,bsfc->bshf", lo[..., ch],
                                       xsf[..., ch])
    a2 = torch.softmax(logits, dim=-1)
    out = torch.einsum("bshf,bsfhd->bshd", a2,
                       xsf.reshape(B, S, F, heads, hd))
    if intermediates is not None:
        intermediates.update(xs=xs, q2=q2, qs=qs, g=g, g_hi=hi, g_lo=lo,
                             logits=logits, a2=a2)
    return out.to(dt).reshape(B, S, C)


# kernel 4 (v7) rounds where kernel 3 (v3) does: one plain version for both
trajectory_core_v7_reference = trajectory_core_v3_reference


def trajectory_core_v6_reference(q, kf, vf, wq2, bq2, wk2, bk2, scale,
                                 heads):
    """Plain version of the v6 kernel, step by step (TPU
    ``_fused_kernel_v6``): k2v = V . Wk2; stage 1 per frame as version 4
    computes it, xs_f = round(p_f / s_f) . V_f rounded; x_diag; q2; the
    stage-2 logits read off M_h = q2_h . k2v_h^T and the stage-1 weights;
    a2 = softmax over frames (float32); out = sum_f a2_f xs_f. Float32
    arithmetic with the kernel's rounding points (q's dtype); bk2 drops
    out."""
    del bk2
    B, S, C = q.shape
    F = kf.shape[1]
    dt = q.dtype
    vh, p, s, k2vh = _variant_stage1(q, kf, vf, wk2, scale, heads)
    w1 = (p / s[..., None]).to(dt).float()
    xs = torch.einsum("bhsfn,bhfnd->bsfhd", w1, vh).to(dt)  # [B,S,F,h,hd]
    x_diag = attn_ops.take_diagonal(xs.reshape(B, S, F, C), F)
    a2 = _variant_a2(x_diag, wq2, bq2, p, s, k2vh, scale, heads)
    out = torch.einsum("bhsf,bsfhd->bshd", a2, xs.float())
    return out.to(dt).reshape(B, S, C)


def trajectory_core_v5_reference(q, kf, vf, wq2, bq2, wk2, bk2, scale,
                                 heads):
    """Plain version of the v5 kernel, step by step (TPU
    ``_fused_kernel_v5``), which never forms xs: k2v = V . Wk2; the
    per-frame weights p and normalisers s; x_diag from the own-frame
    weights alone, round(p_own / s_own) . V_own rounded; q2; M_h, l2 and
    a2 as in v6; and the folded final product out_h = round(p * a2_f /
    s_f) . V_h over all F * N keys at once. Float32 arithmetic with the
    kernel's rounding points (q's dtype); bk2 drops out."""
    del bk2
    B, S, C = q.shape
    F, N = kf.shape[1], kf.shape[2]
    hd, dt = C // heads, q.dtype
    vh, p, s, k2vh = _variant_stage1(q, kf, vf, wk2, scale, heads)
    xd = torch.empty(B, heads, S, hd, dtype=torch.float32, device=q.device)
    for f in range(F):
        rows = slice(f * N, (f + 1) * N)
        own = (p[:, :, rows, f] / s[:, :, rows, f, None]).to(dt).float()
        xd[:, :, rows] = own @ vh[:, :, f]
    x_diag = xd.to(dt).permute(0, 2, 1, 3).reshape(B, S, C)
    a2 = _variant_a2(x_diag, wq2, bq2, p, s, k2vh, scale, heads)
    w = (p * (a2 / s)[..., None]).to(dt).float()
    out = torch.einsum("bhsfn,bhfnd->bshd", w, vh)
    return out.to(dt).reshape(B, S, C)


def trajectory_core_k2v_mirror(q, kf, vf, wq2, bq2, wk2, bk2, scale, heads,
                               version, intermediates=None):
    """Plain mirror of kernels 5 (``version`` 6) and 6 (``version`` 5) on
    the card (``csrc/trajectory_k2v.cuh``): their steps and rounding points,
    in float32 arithmetic on operands at q's dtype. k2v = round(V . Wk2);
    per frame and head the normalised stage-1 weights P = round(p * (1 /
    s)) (p = exp(logit * scale - max), s their float32 sum), O_f = P . V_f
    and Y_f = P . k2v_f in float32; xs = round(O); x_diag the own frame's
    rows of xs; q2 = round(x_diag . Wq2 + bq2); the stage-2 logits l2_f =
    (q2_h . Y_f) * scale, which equal the TPU kernels' sum_n p M / s with
    M_h = q2_h . k2v_h^T in exact arithmetic; then the softmax over frames
    online, frame by frame: a running max m, sum z and mix acc, rescaled by
    exp(m - m_new) and added exp(l2_f - m_new) times xs_f (v6) or O_f (v5);
    out = round(acc / z). At N > 256 the chunked form's stage 1
    (``_chunked_stage1``, as the own-frame launch and the pass form it): a
    frame's keys in two chunks, P rounded unnormalised against the running
    max, O and Y summed over the chunks and rescaled online, then O_f = O /
    l and Y_f = Y / l in float32 (the products' sums times 1 / l), xs =
    round(O_f). Returns out; a dict passed as ``intermediates`` receives
    k2v, p_bf16 (P, at N <= 256), o, y, xs, x_diag, q2, l2 and the
    unrounded out_f32 ([B, heads, S, ...] head-split where per head).
    Nothing on the card calls it."""
    del bk2
    if version not in (5, 6):
        raise ValueError(f"the k2v design serves versions 5 and 6, not "
                         f"{version!r}")
    B, S, C = q.shape
    F, N = kf.shape[1], kf.shape[2]
    hd, dt = C // heads, q.dtype

    def rnd(t):
        return t.to(dt).float()

    k2v = rnd(vf.float().reshape(B, F * N, C) @ wk2.to(dt).float())
    w = None
    if N > MAX_KEYS:
        o, y = _chunked_stage1(q, kf, [vf, k2v.reshape(B, F, N, C)], scale,
                               heads)
    else:
        k2vh = k2v.reshape(B, F, N, heads, hd).permute(0, 3, 1, 2, 4)
        vh, p, s = _stage1_weights(q, kf, vf, scale, heads)
        w = rnd(p * (1 / s)[..., None])  # [B, h, S, F, N]
        o = torch.einsum("bhsfn,bhfnd->bhsfd", w, vh)
        y = torch.einsum("bhsfn,bhfnd->bhsfd", w, k2vh)
    xs = o.to(dt).permute(0, 2, 3, 1, 4).reshape(B, S, F, C)
    x_diag = attn_ops.take_diagonal(xs, F)
    q2 = (x_diag.float() @ wq2.to(dt).float() + bq2.to(dt).float()).to(dt)
    q2h = q2.float().reshape(B, S, heads, hd).permute(0, 2, 1, 3)
    l2 = torch.einsum("bhsd,bhsfd->bhsf", q2h, y) * scale
    mixed = rnd(o) if version == 6 else o
    m = torch.full(l2.shape[:-1], -torch.inf, device=q.device)
    z = torch.zeros_like(m)
    acc = torch.zeros(B, heads, S, hd, device=q.device)
    for f in range(F):
        m_new = torch.maximum(m, l2[..., f])
        alpha, wf = torch.exp(m - m_new), torch.exp(l2[..., f] - m_new)
        z = z * alpha + wf
        acc = acc * alpha[..., None] + wf[..., None] * mixed[..., f, :]
        m = m_new
    out = (acc / z[..., None]).permute(0, 2, 1, 3).reshape(B, S, C)
    if intermediates is not None:
        intermediates.update(k2v=k2v, o=o, y=y, xs=xs, x_diag=x_diag,
                             q2=q2, l2=l2, out_f32=out)
        if w is not None:
            intermediates["p_bf16"] = w
    return out.to(dt)


# kernels 5 and 6's pass (csrc/trajectory_k2v.cuh): units of 128 query rows,
# frame slots of K, V and k2v
K2V_PASS_ROWS = 128


def k2v_pass_plan(N):
    """The pass's shared-memory plan at N keys a frame, as
    ``csrc/trajectory_k2v.cuh`` computes it (``kp_slots``, ``kp_stages``,
    ``k2v_pass_smem_bytes``): keys padded to an instantiated wgmma width,
    Q tiles, and xs staging tiles a warpgroup (two of each, one past NP =
    208), slots of K, V and k2v (at most four, as many as fit), and the
    bytes; past MAX_KEYS the chunked form's, a slot holding one chunk of a
    frame's keys (``chunk_keys``, two chunks a frame). Raises
    ``ValueError`` where the kernel takes no such N."""
    ta._check_keys(N)
    chunked = N > MAX_KEYS
    np_ = (chunk_keys(N) if chunked
           else next(w for w in (64, 128, 208, 256) if N <= w))
    row_bytes = 2 * HEAD_DIM
    slots = 1 if np_ > 208 else 2
    stage_bytes = 3 * np_ * row_bytes
    fixed = (1024 + slots * K2V_PASS_ROWS * row_bytes
             + 2 * slots * 64 * row_bytes + 1024)
    stages = min(4, (SMEM_LIMIT - fixed) // stage_bytes)
    chunks = STAGE1_CHUNKS if chunked else 1
    return {"padded_keys": chunks * np_, "chunk_keys": np_,
            "chunks": chunks, "slots": slots,
            "stage_bytes": stage_bytes, "stages": stages,
            "smem_bytes": fixed + stages * stage_bytes}


def trajectory_core_backward_reference(q, kf, vf, wq2, bq2, wk2, bk2, dout,
                                       scale, heads, intermediates=None):
    """Plain version of the backward, in float32, step by step as the TPU
    kernel (``_fused_bwd_kernel``) computes it: the stage-1 and stage-2
    forward recomputed, then the stage-2 backward (per head g_h, the logits
    over F, their softmax, dl2, dg_h, dq2, dWk2, dbq2, dWq2, and dxs from the
    logit, value and own-frame terms), then the stage-1 backward (dv, dz, dq,
    dk per batch row, head and frame). Returns (dq, dkf, dvf, dwq2, dbq2,
    dwk2, dbk2) in the operands' dtypes; dbk2 is zero (bk2 drops out of the
    softmax). A dict passed as ``intermediates`` receives xs, q2, dq2 and
    dxs (float32)."""
    B, S, C = q.shape
    F, N = kf.shape[1], kf.shape[2]
    hd = C // heads
    q_, k_, v_, w_q2, b_q2, w_k2, do = (
        t.float() for t in (q, kf, vf, wq2, bq2, wk2, dout))
    frame = torch.arange(S, device=q.device) // N
    rows = torch.arange(S, device=q.device)

    # stage-1 forward: a1[b, h, s, f, n], xs[b, s, f, c]
    qh = q_.reshape(B, S, heads, hd).permute(0, 2, 1, 3)
    kh = k_.reshape(B, F, N, heads, hd).permute(0, 3, 1, 2, 4)
    vh = v_.reshape(B, F, N, heads, hd).permute(0, 3, 1, 2, 4)
    a1 = torch.softmax(torch.einsum("bhsd,bhfnd->bhsfn", qh, kh) * scale, -1)
    xs = torch.einsum("bhsfn,bhfnd->bsfhd", a1, vh).reshape(B, S, F, C)
    x_diag = xs[:, rows, frame]
    q2 = x_diag @ w_q2 + b_q2

    # stage-2 forward: g[b, s, h, c] = q2_h . Wk2[:, h]^T, a2[b, s, h, f]
    q2h = q2.reshape(B, S, heads, hd)
    wk2h = w_k2.reshape(C, heads, hd)
    g = torch.einsum("bshd,chd->bshc", q2h, wk2h)
    a2 = torch.softmax(torch.einsum("bshc,bsfc->bshf", g, xs) * scale, -1)

    # stage-2 backward
    doh = do.reshape(B, S, heads, hd)
    da2 = torch.einsum("bshd,bsfhd->bshf", doh, xs.reshape(B, S, F, heads, hd))
    dl2 = scale * a2 * (da2 - (a2 * da2).sum(-1, keepdim=True))
    dg = torch.einsum("bshf,bsfc->bshc", dl2, xs)
    dq2 = torch.einsum("bshc,chd->bshd", dg, wk2h).reshape(B, S, C)
    dwk2 = torch.einsum("bshc,bshd->chd", dg, q2h).reshape(C, C)
    dbq2 = dq2.sum((0, 1))
    dwq2 = torch.einsum("bsi,bso->io", x_diag, dq2)
    dxs = (torch.einsum("bshf,bshc->bsfc", dl2, g)
           + torch.einsum("bshf,bshd->bsfhd", a2, doh).reshape(B, S, F, C))
    dxs[:, rows, frame] += dq2 @ w_q2.t()

    # stage-1 backward, per (batch row, head, frame)
    dxsh = dxs.reshape(B, S, F, heads, hd).permute(0, 3, 1, 2, 4)
    dv = torch.einsum("bhsfn,bhsfd->bhfnd", a1, dxsh)
    da1 = torch.einsum("bhsfd,bhfnd->bhsfn", dxsh, vh)
    dz = a1 * (da1 - (a1 * da1).sum(-1, keepdim=True))
    dq = scale * torch.einsum("bhsfn,bhfnd->bhsd", dz, kh)
    dk = scale * torch.einsum("bhsfn,bhsd->bhfnd", dz, qh)

    if intermediates is not None:
        intermediates.update(xs=xs, q2=q2, dq2=dq2, dxs=dxs)
    return (dq.permute(0, 2, 1, 3).reshape(B, S, C).to(q.dtype),
            dk.permute(0, 2, 3, 1, 4).reshape(B, F, N, C).to(kf.dtype),
            dv.permute(0, 2, 3, 1, 4).reshape(B, F, N, C).to(vf.dtype),
            dwq2.to(wq2.dtype), dbq2.to(bq2.dtype), dwk2.to(wk2.dtype),
            torch.zeros_like(bk2))


def _chunked_softmax_and_r(logits, dp, cw):
    """The chunked dq kernel's first sweep over a frame's keys in chunks of
    ``cw`` (float32): the max m, l = sum exp(s - m) and r' = sum exp(s -
    m) dP carried online -> (P = exp(s - m - log l), r = r' / l)."""
    m = l = rp = None
    for keys in (slice(0, cw), slice(cw, logits.shape[-1])):
        part = logits[..., keys]
        m_new = part.amax(-1) if m is None else torch.maximum(
            m, part.amax(-1))
        p = torch.exp(part - m_new[..., None])
        pl, pr = p.sum(-1), (p * dp[..., keys]).sum(-1)
        if m is None:
            l, rp = pl, pr
        else:
            alpha = torch.exp(m - m_new)
            l, rp = l * alpha + pl, rp * alpha + pr
        m = m_new
    return torch.exp(logits - (m + torch.log(l))[..., None]), rp / l


def trajectory_core_backward_mirror(q, kf, vf, wq2, wk2, dout, xs, q2,
                                    scale, heads, r_from_stage2=False):
    """Plain mirror of the backward kernel (``csrc/trajectory_block_bwd.cu``):
    its order of work and its rounding points, in float32 arithmetic on
    operands at q's dtype, from the forward's residuals xs [B, S, F, C] and
    q2 [B, S, C]. Stage 2 in the TPU kernel's g-form: g_h = q2_h . Wk2_h^T
    (float32), the logits g_h . xs_f, a2, da2 = dout_h . xs_f,h, dl2; dg_h =
    sum_f dl2 xs_f rounded; dq2 = dg_h . Wk2_h (float32) and its rounding
    dq2b; dWk2 = sum dg_h^T q2_h, dWq2 = x_diag^T dq2b, dbq2 = sum dq2, dd =
    dq2b . Wq2^T; dxs = sum_h dl2 g_h + a2 dout + dd on the own frame,
    rounded. Stage 1: the true max-subtracted softmax P, dP = dxs . V, dS =
    P (dP - r) in float32, dq and dk from dS, dv from P rounded. r is
    sum_n P dP, as the dq kernel forms it; with ``r_from_stage2`` it is
    dxs_f,h . xs_f,h of the rounded operands instead, which stage 2 could
    hand over and which misses the gate on peaked stage-1 logits. At N >
    MAX_KEYS the order of the chunked dq kernel: a first sweep over a
    frame's two chunks (``chunk_keys``) carries the max m, l = sum exp(s -
    m) and r' = sum exp(s - m) dP online (both scaled by exp(m_old - m_new)
    when chunk 1 raises the max), r = r' / l; then P = exp(s - m - log l)
    for dS, dk and dv. Returns (dq, dkf, dvf) at q's dtype and (dwq2, dbq2,
    dwk2) in float32. Nothing on the card calls it."""
    B, S, C = q.shape
    F, N = kf.shape[1], kf.shape[2]
    hd, dt = C // heads, q.dtype

    def rnd(t):
        return t.to(dt).float()

    xsf = xs.float()
    xsh = xsf.reshape(B, S, F, heads, hd)
    q2h = q2.float().reshape(B, S, heads, hd)
    wk2h = wk2.float().reshape(C, heads, hd)
    doh = dout.float().reshape(B, S, heads, hd)
    rows = torch.arange(S, device=q.device)
    frame = rows // N

    # stage 2: logits and dl2
    g = torch.einsum("bshd,chd->bshc", q2h, wk2h)
    a2 = torch.softmax(torch.einsum("bshc,bsfc->bshf", g, xsf) * scale, -1)
    da2 = torch.einsum("bshd,bsfhd->bshf", doh, xsh)
    dl2 = scale * a2 * (da2 - (a2 * da2).sum(-1, keepdim=True))
    # dq2 and the weight gradients from dg, rounded as an operand
    dgb = rnd(torch.einsum("bshf,bsfc->bshc", dl2, xsf))
    dq2 = torch.einsum("bshc,chd->bshd", dgb, wk2h).reshape(B, S, C)
    dq2b = rnd(dq2)
    dwk2 = torch.einsum("bshc,bshd->chd", dgb, q2h).reshape(C, C)
    dwq2 = torch.einsum("bsi,bso->io", xsf[:, rows, frame], dq2b)
    dbq2 = dq2.sum((0, 1))
    dd = dq2b @ wq2.float().t()
    # dxs, rounded once
    dxs = (torch.einsum("bshf,bshc->bsfc", dl2, g)
           + torch.einsum("bshf,bshd->bsfhd", a2, doh).reshape(B, S, F, C))
    dxs[:, rows, frame] += dd
    dxsh = rnd(dxs).reshape(B, S, F, heads, hd).permute(0, 3, 1, 2, 4)

    # stage 1
    qh = q.float().reshape(B, S, heads, hd).permute(0, 2, 1, 3)
    kh = kf.float().reshape(B, F, N, heads, hd).permute(0, 3, 1, 2, 4)
    vh = vf.float().reshape(B, F, N, heads, hd).permute(0, 3, 1, 2, 4)
    logits = torch.einsum("bhsd,bhfnd->bhsfn", qh, kh) * scale
    dp = torch.einsum("bhsfd,bhfnd->bhsfn", dxsh, vh)
    if N > MAX_KEYS:
        p, r = _chunked_softmax_and_r(logits, dp, chunk_keys(N))
    else:
        p = torch.softmax(logits, -1)
        r = (p * dp).sum(-1)
    if r_from_stage2:
        r = (dxsh * xsh.permute(0, 3, 1, 2, 4)).sum(-1)
    ds = p * (dp - r[..., None])
    dq = scale * torch.einsum("bhsfn,bhfnd->bhsd", ds, kh)
    dk = scale * torch.einsum("bhsfn,bhsd->bhfnd", ds, qh)
    dv = torch.einsum("bhsfn,bhsfd->bhfnd", rnd(p), dxsh)
    return (dq.permute(0, 2, 1, 3).reshape(B, S, C).to(dt),
            dk.permute(0, 2, 3, 1, 4).reshape(B, F, N, C).to(dt),
            dv.permute(0, 2, 3, 1, 4).reshape(B, F, N, C).to(dt),
            dwq2, dbq2, dwk2)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    return _build.bind("trajectory_block", "traj_core_bf16",
                       n_ptr=9, n_int=6, n_float=1)


@functools.lru_cache(maxsize=None)
def _v3_kernel_fn():
    return _build.bind("trajectory_block", "traj_core_v3_bf16",
                       n_ptr=10, n_int=6, n_float=1)


@functools.lru_cache(maxsize=None)
def _v7_kernel_fn():
    return _build.bind("trajectory_block", "traj_core_v7_bf16",
                       n_ptr=10, n_int=6, n_float=1)


@functools.lru_cache(maxsize=None)
def _bwd_kernel_fn():
    return _build.bind("trajectory_block_bwd", "traj_core_bwd_bf16",
                       n_ptr=25, n_int=6, n_float=1)


_VARIANT_SYMBOLS = {5: ("trajectory_block_v5", "traj_core_v5_bf16"),
                    6: ("trajectory_block_v6", "traj_core_v6_bf16")}


@functools.lru_cache(maxsize=None)
def _variant_kernel_fn(version):
    return _build.bind(*_VARIANT_SYMBOLS[version], n_ptr=11, n_int=6,
                       n_float=1)


def _check_operands(q, kf, vf, wq2, bq2, wk2, heads, extra=()):
    """Raises where the kernels take no such operands: bf16 alone,
    contiguous on one device, the layout's shapes, and N <=
    MAX_KEYS_CHUNKED keys a frame."""
    B, S, C = q.shape
    F, N = kf.shape[1], kf.shape[2]
    args = (q, kf, vf, wq2, bq2, wk2) + tuple(extra)
    if any(t.dtype != torch.bfloat16 for t in args):
        raise TypeError("trajectory kernel takes bfloat16 operands, got "
                        f"{[t.dtype for t in args]}; its float32 mode is "
                        "open (ROADMAP.md section 2 A2)")
    if any(t.device != q.device for t in args):
        raise ValueError("trajectory kernel operands must share one device")
    if any(not t.is_contiguous() for t in args):
        raise ValueError("trajectory kernel operands must be contiguous")
    shapes_ok = (
        tuple(kf.shape) == (B, F, N, C) and tuple(vf.shape) == (B, F, N, C)
        and tuple(wq2.shape) == (C, C) and tuple(wk2.shape) == (C, C)
        and tuple(bq2.shape) == (C,) and S == F * N
    )
    if not shapes_ok:
        raise ValueError(f"bad shapes for the trajectory kernel: "
                         f"{[tuple(t.shape) for t in args]}")
    if (C != heads * HEAD_DIM or C % 128 or F > 8 or N > MAX_KEYS_CHUNKED
            or heads > 16):
        raise ValueError(f"trajectory kernel needs head dim {HEAD_DIM}, "
                         f"C % 128 == 0, F <= 8, N <= {MAX_KEYS_CHUNKED}, "
                         f"heads <= 16 (C={C}, heads={heads}, F={F}, N={N})")


def _launch(q, kf, vf, wq2, bq2, wk2, scale, heads):
    """Forward kernel -> (out, xs, q2); xs [B, S, F, C] and q2 [B, S, C]
    are the stage-1 aggregates and stage-2 queries it writes on the way,
    which the backward reads."""
    global LAUNCHES
    _check_operands(q, kf, vf, wq2, bq2, wk2, heads)
    B, S, C = q.shape
    F, N = kf.shape[1], kf.shape[2]
    xs = torch.empty(B, S, F, C, dtype=torch.bfloat16, device=q.device)
    q2 = torch.empty(B, S, C, dtype=torch.bfloat16, device=q.device)
    out = torch.empty(B, S, C, dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel_fn()(
            q.data_ptr(), kf.data_ptr(), vf.data_ptr(), wq2.data_ptr(),
            bq2.data_ptr(), wk2.data_ptr(), xs.data_ptr(), q2.data_ptr(),
            out.data_ptr(),
            B, S, F, N, C, heads, float(scale), stream,
        )
    _build.check(err, "traj_core_bf16")
    LAUNCHES += 1
    return out, xs, q2


def _launch_one(kernel_fn, symbol, q, kf, vf, wq2, bq2, wk2, scale, heads):
    """The v3 or v7 forward (kernel 1's three launches in the rounding mode
    V3, bound by ``kernel_fn`` once the operands pass their check) -> (out,
    xs, q2, device launches), xs and q2 written as ``_launch`` writes them
    (q2 unscaled, with its bias), so the backward kernel reads them
    unchanged."""
    _check_operands(q, kf, vf, wq2, bq2, wk2, heads)
    B, S, C = q.shape
    F, N = kf.shape[1], kf.shape[2]
    xs = torch.empty(B, S, F, C, dtype=torch.bfloat16, device=q.device)
    q2 = torch.empty(B, S, C, dtype=torch.bfloat16, device=q.device)
    out = torch.empty(B, S, C, dtype=torch.bfloat16, device=q.device)
    launched = ctypes.c_int(0)
    kernel = kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = kernel(
            q.data_ptr(), kf.data_ptr(), vf.data_ptr(), wq2.data_ptr(),
            bq2.data_ptr(), wk2.data_ptr(), xs.data_ptr(), q2.data_ptr(),
            out.data_ptr(), ctypes.addressof(launched),
            B, S, F, N, C, heads, float(scale), stream,
        )
    _build.check(err, symbol)
    return out, xs, q2, launched.value


def _launch_v3(q, kf, vf, wq2, bq2, wk2, scale, heads):
    """The v3 forward, three device launches -> (out, xs, q2)."""
    global V3_LAUNCHES, V3_DEVICE_LAUNCHES
    out, xs, q2, launched = _launch_one(
        _v3_kernel_fn, "traj_core_v3_bf16", q, kf, vf, wq2, bq2, wk2,
        scale, heads)
    V3_LAUNCHES += 1
    V3_DEVICE_LAUNCHES += launched
    return out, xs, q2


def _launch_v7(q, kf, vf, wq2, bq2, wk2, scale, heads):
    """The v7 forward (the v3 design: the two TPU kernels compute one
    function), three device launches -> (out, xs, q2)."""
    global V7_LAUNCHES, V7_DEVICE_LAUNCHES
    out, xs, q2, launched = _launch_one(
        _v7_kernel_fn, "traj_core_v7_bf16", q, kf, vf, wq2, bq2, wk2,
        scale, heads)
    V7_LAUNCHES += 1
    V7_DEVICE_LAUNCHES += launched
    return out, xs, q2


def _launch_variant(version, q, kf, vf, wq2, bq2, wk2, scale, heads):
    """The v5 or v6 forward kernel, four device launches -> (out, xs, q2,
    scratch). v6 writes xs [B, S, F, C] and q2 [B, S, C] as version 4 does
    (the backward reads them; xs's own-frame rows are the own-frame
    launch's x_diag, which v6 parks in out); v5 forms no xs (None). Both
    form q2 from the own-frame aggregates. ``scratch`` holds k2v
    [B, F * N, C] and, for v5, the own-frame aggregates x_diag
    [B, S, C]."""
    global V5_LAUNCHES, V5_DEVICE_LAUNCHES, V6_LAUNCHES, V6_DEVICE_LAUNCHES
    _check_operands(q, kf, vf, wq2, bq2, wk2, heads)
    B, S, C = q.shape
    F, N = kf.shape[1], kf.shape[2]

    def buf(*shape):
        return torch.empty(*shape, dtype=torch.bfloat16, device=q.device)

    scratch = {"k2v": buf(B, F * N, C)}
    if version == 6:
        xs = buf(B, S, F, C)
    else:
        xs, scratch["x_diag"] = None, buf(B, S, C)
    q2, out = buf(B, S, C), buf(B, S, C)
    aggregates = xs if version == 6 else scratch["x_diag"]
    launched = ctypes.c_int(0)
    kernel = _variant_kernel_fn(version)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = kernel(
            q.data_ptr(), kf.data_ptr(), vf.data_ptr(), wq2.data_ptr(),
            bq2.data_ptr(), wk2.data_ptr(), scratch["k2v"].data_ptr(),
            aggregates.data_ptr(), q2.data_ptr(), out.data_ptr(),
            ctypes.addressof(launched),
            B, S, F, N, C, heads, float(scale), stream,
        )
    _build.check(err, _VARIANT_SYMBOLS[version][1])
    if version == 5:
        V5_LAUNCHES += 1
        V5_DEVICE_LAUNCHES += launched.value
    else:
        V6_LAUNCHES += 1
        V6_DEVICE_LAUNCHES += launched.value
    return out, xs, q2, scratch


def _launch_backward(q, kf, vf, wq2, bq2, wk2, dout, xs, q2, scale, heads,
                     scratch=None):
    """Backward kernel -> (dq, dkf, dvf, dwq2, dbq2, dwk2) in the operands'
    dtype (bf16). A dict passed as ``scratch`` receives the kernel's scratch
    tensors (among them dxs [B, S, F, C] and dq2 [B, S, C]); none of them is
    a float32 [B S F, C] tensor. Its stage-2 tiles hold C <= 768 (12
    heads); N <= 512 keys a frame (past 256 its dq kernel's chunked
    form), and 513 is refused before any build."""
    global BWD_LAUNCHES, BWD_DEVICE_LAUNCHES
    _check_operands(q, kf, vf, wq2, bq2, wk2, heads, (dout, xs, q2))
    B, S, C = q.shape
    F, N = kf.shape[1], kf.shape[2]
    if (tuple(dout.shape) != (B, S, C) or tuple(xs.shape) != (B, S, F, C)
            or tuple(q2.shape) != (B, S, C)):
        raise ValueError("dout, xs and q2 do not match the operands")
    if C > 768:
        raise ValueError(f"trajectory backward kernel holds C <= 768 (12 "
                         f"heads) in its stage-2 tiles, got C={C}")
    dev, M = q.device, B * S

    def buf(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device=dev)

    bf = torch.bfloat16
    grads = (buf(B, S, C, dtype=bf), buf(B, F, N, C, dtype=bf),
             buf(B, F, N, C, dtype=bf), buf(C, C), buf(C), buf(C, C))
    work = {"a2": buf(M, heads, F), "dl2": buf(M, heads, F),
            "dxs": buf(B, S, F, C, dtype=bf), "dq2": buf(B, S, C),
            "dq2b": buf(M, C, dtype=bf), "dd": buf(M, C),
            "part": buf(16, C, C), "wpart": buf(5, C, C),
            "bpart": buf(2 * -(-M // 32), C),
            "stats": buf(2, B, heads, F, -(-S // 4) * 4)}
    launched = ctypes.c_int(0)
    kernel = _bwd_kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernel(
            q.data_ptr(), kf.data_ptr(), vf.data_ptr(), wq2.data_ptr(),
            wk2.data_ptr(), dout.data_ptr(), xs.data_ptr(), q2.data_ptr(),
            *(g.data_ptr() for g in grads),
            *(w.data_ptr() for w in work.values()),
            ctypes.addressof(launched),
            B, S, F, N, C, heads, float(scale), stream,
        )
    _build.check(err, "traj_core_bwd_bf16")
    BWD_LAUNCHES += 1
    BWD_DEVICE_LAUNCHES += launched.value
    if scratch is not None:
        scratch.update(work)
    dq, dkf, dvf, dwq2, dbq2, dwk2 = grads
    return (dq, dkf, dvf, dwq2.to(wq2.dtype), dbq2.to(bq2.dtype),
            dwk2.to(wk2.dtype))


class _FusedCore(torch.autograd.Function):
    """The forward kernel of ``FWD_VERSION``, with xs and q2 kept for the
    backward kernel (the counterpart of ``jax.custom_vjp`` over
    ``fused_trajectory_core``); v3, v6 and v7 write them as version 4 does.
    v5 forms no xs: its backward first
    recomputes xs and q2 with the version-4 kernel (counted in
    ``LAUNCHES``), as the TPU backward recomputes stage 1 itself."""

    @staticmethod
    def forward(ctx, q, kf, vf, wq2, bq2, wk2, bk2, scale, heads, version):
        if version in (3, 4, 7):
            launch = {3: _launch_v3, 4: _launch, 7: _launch_v7}[version]
            out, xs, q2 = launch(q, kf, vf, wq2, bq2, wk2, scale, heads)
        else:
            out, xs, q2, _ = _launch_variant(version, q, kf, vf, wq2, bq2,
                                             wk2, scale, heads)
            if xs is None:
                q2 = None
        ctx.save_for_backward(q, kf, vf, wq2, bq2, wk2, bk2, xs, q2)
        ctx.scale, ctx.heads = scale, heads
        return out

    @staticmethod
    def backward(ctx, dout):
        q, kf, vf, wq2, bq2, wk2, bk2, xs, q2 = ctx.saved_tensors
        if xs is None:
            _, xs, q2 = _launch(q, kf, vf, wq2, bq2, wk2, ctx.scale,
                                ctx.heads)
        grads = _launch_backward(q, kf, vf, wq2, bq2, wk2, dout.contiguous(),
                                 xs, q2, ctx.scale, ctx.heads)
        return (*grads, torch.zeros_like(bk2), None, None, None)


def fused_trajectory_core(q, kf, vf, wq2, bq2, wk2, bk2, scale, heads):
    """Trajectory attention for the non-CLS tokens -> [B, S, C].

    A CPU tensor takes the plain version at every ``FWD_VERSION`` (its
    gradient is autograd's); a CUDA tensor launches the forward kernel of
    ``FWD_VERSION`` (3, 4, 5, 6 or 7; others raise before any launch), and
    its gradient the backward kernel (bf16, contiguous, head dim 64, N <=
    512 keys a frame at every version), or raises: a float32 operand raises
    ``TypeError``, N > 512 ``ValueError``."""
    if q.device.type == "cpu":
        return trajectory_core_reference(q, kf, vf, wq2, bq2, wk2, bk2,
                                         scale, heads)
    if q.device.type != "cuda":
        raise ValueError(f"no trajectory kernel for device {q.device}")
    version = check_fwd_version()
    return _FusedCore.apply(q, kf, vf, wq2, bq2, wk2, bk2, scale, heads,
                            version)
