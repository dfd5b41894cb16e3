"""Trajectory-attention stage 1 alone (the space stage): its plain PyTorch
forward and backward, and the wrapper of its CUDA kernel
(``csrc/trajectory_attention.cu``) joined to the plain backward by a
``torch.autograd.Function``.

Counterpart of ``focus_tpu/ops/pallas/trajectory_attention.py``
(``space_stage``, ``space_stage_fused`` and its backward
``_space_stage_bwd``), with the JAX signature and layout: q_, k_, v_
``[BH, S, d]`` with S = F * N, result ``[BH, S, F, d]``:

    out[bh, q, f] = softmax(q . k_f^T * scale) . v_f

over frame f's N keys, a true max-subtracted softmax whose weights are
rounded to v's dtype before the product. The learned-v trajectory attention
(``use_original_code=False``) runs it; the fused trajectory core
(``ops/trajectory_block.py``) does not.

Keys a frame: N <= 512. Past 256 the kernel runs the chunked form of
``csrc/space_stage_core.cuh`` (kernel 1's at N > 256: two chunks of
``chunk_keys`` keys a frame, the softmax online across them, the weights
rounded unnormalised and the frame's sums scaled by 1 / l), whose steps
``space_stage_chunked_mirror`` follows; at N <= 256 the weights are
normalised before the rounding, as the TPU kernel rounds them. N = 513
raises ``ValueError`` before any build.

Float32 operands on the card: the kernel takes bf16 alone, so a CUDA call
with a float32 operand raises ``TypeError``: its float32 mode is open
(ROADMAP.md section 2 A2). Nothing on the card falls back to the plain
version.
"""

import functools

import torch

from focus_tpu_torch.ops import _build
from focus_tpu_torch.ops import attention as attn_ops

# kernel launches since the last reset (one per wrapper call on the card)
LAUNCHES = 0

HEAD_DIM = 64  # the kernel's head dim
MAX_KEYS = 256  # keys a frame in one pass: the widest wgmma of the logits
MAX_KEYS_CHUNKED = 512  # keys a frame in the chunked form (two chunks)
STAGE1_CHUNKS = 2  # the chunked form: a frame's keys in two chunks
SMEM_LIMIT = 232_448  # shared memory a block may use on this card
H100_SMS = 132


def _check_keys(N):
    if not 1 <= N <= MAX_KEYS_CHUNKED:
        raise ValueError(f"space-stage kernel needs N <= {MAX_KEYS_CHUNKED} "
                         f"(N={N})")


def chunk_keys(N):
    """Keys a chunk of the chunked stage 1 at N > MAX_KEYS
    (``ss_chunk_keys``): two chunks of 224 up to N = 448, else of 256."""
    return 224 if N <= 448 else 256


def chunked_stage1_plan(BH, S, F, N, sms=H100_SMS):
    """The stage-1 kernel's chunked form at MAX_KEYS < N <=
    MAX_KEYS_CHUNKED, as ``csrc/space_stage_core.cuh`` plans it (kernel 8,
    and kernels 1, 3 and 4's stage 1, at B x heads head rows): a ring slot
    holds one chunk of a frame's keys (K and V, ``chunk_keys`` rows each),
    one output staging tile a warpgroup (a frame leaves every second turn),
    as many slots as fit beside them and the Q ring (at most four), and the
    persistent grid of (bh, 128-query tile) units. Raises ``ValueError``
    where the chunked form takes no such N."""
    if not MAX_KEYS < N <= MAX_KEYS_CHUNKED:
        raise ValueError(f"the chunked stage 1 takes {MAX_KEYS} < N <= "
                         f"{MAX_KEYS_CHUNKED} (N={N})")
    cw = chunk_keys(N)
    row = 2 * HEAD_DIM
    rows, consumers, out_slots = 128, 2, 1
    fixed = 1024 + 2 * rows * row + consumers * out_slots * 64 * row + 1024
    stage = 2 * cw * row
    stages = min(4, (SMEM_LIMIT - fixed) // stage)
    tiles = -(-S // rows)
    units = BH * tiles
    return {"padded_keys": STAGE1_CHUNKS * cw, "chunk_keys": cw,
            "chunks": STAGE1_CHUNKS, "out_slots": out_slots,
            "stages": stages, "smem_bytes": fixed + stages * stage,
            "query_tiles": tiles, "rows_per_tile": rows, "units": units,
            "grid": min(units, sms), "threads": 128 * (consumers + 1)}


def space_stage_plan(BH, S, F, N, sms=H100_SMS):
    """The kernel's launch plan, as ``csrc/trajectory_attention.cu``
    computes it: keys padded to an instantiated wgmma width, the frame
    slots of K and V that fit beside the Q ring and the output staging
    tiles, shared memory, and the persistent grid walking (bh, 128-query
    tile) units; past MAX_KEYS keys the chunked form's
    (``chunked_stage1_plan``). Raises ``ValueError`` where the kernel takes
    no such N."""
    _check_keys(N)
    if N > MAX_KEYS:
        return chunked_stage1_plan(BH, S, F, N, sms)
    padded = next(w for w in (64, 128, 208, 256) if N <= w)
    row = 2 * HEAD_DIM  # bytes of a bf16 row
    rows, consumers = 128, 2  # query rows a unit, warpgroups of 64 rows
    fixed = 1024 + 2 * rows * row + consumers * 2 * 64 * row + 1024
    stage = 2 * padded * row
    stages = min(4, (SMEM_LIMIT - fixed) // stage)
    tiles = -(-S // rows)
    units = BH * tiles
    return {"padded_keys": padded, "stages": stages,
            "smem_bytes": fixed + stages * stage, "query_tiles": tiles,
            "rows_per_tile": rows, "units": units, "grid": min(units, sms),
            "threads": 128 * (consumers + 1)}


def chunked_stage1_sums(q, kf, values, scale):
    """The chunked stage 1's steps and rounding points at one head, in
    float32 arithmetic on operands at q's dtype: q [BH, S, d], kf and each
    of ``values`` [BH, F, N, d]. A frame's keys in two chunks
    (``chunk_keys``), the softmax online across them: chunk 0's row max m0,
    p0 = exp(logit * scale - m0 * scale), l = sum p0, o = round(p0) . V_0;
    chunk 1 raises the max to m1, scales l and o by exp((m0 - m1) * scale)
    and adds its own p1 and round(p1) . V_1. Returns, for each value
    tensor, its frame sums times 1 / l in float32 ([BH, S, F, d]). Nothing
    on the card calls it."""
    N, dt = kf.shape[2], q.dtype
    cw = chunk_keys(N)
    logits = torch.einsum("bsd,bfnd->bsfn", q.float(), kf.float()) * scale
    m = l = sums = None
    for keys in (slice(0, cw), slice(cw, N)):
        part = logits[..., keys]
        m_new = part.amax(-1) if m is None else torch.maximum(
            m, part.amax(-1))
        p = torch.exp(part - m_new[..., None])
        pr = p.to(dt).float()
        new = [torch.einsum("bsfn,bfnd->bsfd", pr, v.float()[:, :, keys])
               for v in values]
        if m is None:
            l, sums = p.sum(-1), new
        else:
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            sums = [a * alpha[..., None] + b for a, b in zip(sums, new)]
        m = m_new
    inv = (1 / l)[..., None]
    return [a * inv for a in sums]


def space_stage_chunked_mirror(q, kf, vf, scale):
    """Plain mirror of the kernel at MAX_KEYS < N <= MAX_KEYS_CHUNKED (the
    chunked form, ``chunked_stage1_sums``): q [BH, S, d], kf, vf
    [BH, F, N, d] -> out [BH, S, F, d] = round(o * (1 / l)) at q's dtype.
    The weights are rounded unnormalised, where the kernel at N <= 256 and
    the TPU kernel normalise them first. Nothing on the card calls it."""
    return chunked_stage1_sums(q, kf, [vf], scale)[0].to(q.dtype)


def space_stage_backward_reference(q, kf, vf, g, scale):
    """Plain backward in float32, step by step as ``_space_stage_bwd``: the
    per-frame softmax recomputed from q and kf, then dp = g . vf^T, the
    softmax's backward, and dq, dk, dv. q [BH, S, d]; kf, vf [BH, F, N, d];
    g [BH, S, F, d]. Returns (dq, dkf, dvf) in the operands' dtypes."""
    q32, k32, v32, g32 = (t.float() for t in (q, kf, vf, g))
    logits = torch.einsum("bqd,bfnd->bqfn", q32, k32) * scale
    p = torch.softmax(logits, dim=-1)
    dp = torch.einsum("bqfd,bfnd->bqfn", g32, v32)
    dlogits = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = torch.einsum("bqfn,bfnd->bqd", dlogits, k32) * scale
    dk = torch.einsum("bqfn,bqd->bfnd", dlogits, q32) * scale
    dv = torch.einsum("bqfn,bqfd->bfnd", p, g32)
    return dq.to(q.dtype), dk.to(kf.dtype), dv.to(vf.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    return _build.bind("trajectory_attention", "space_stage_bf16",
                       n_ptr=4, n_int=5, n_float=1)


def _launch(q, kf, vf, scale):
    """Kernel -> out [BH, S, F, d] (bf16), written in that layout."""
    global LAUNCHES
    BH, S, d = q.shape
    F, N = kf.shape[1], kf.shape[2]
    args = (q, kf, vf)
    if any(t.dtype != torch.bfloat16 for t in args):
        raise TypeError("space-stage kernel takes bfloat16 operands, got "
                        f"{[t.dtype for t in args]}; its float32 mode is "
                        "open (ROADMAP.md section 2 A2)")
    if any(t.device != q.device for t in args):
        raise ValueError("space-stage kernel operands must share one device")
    if any(not t.is_contiguous() for t in args):
        raise ValueError("space-stage kernel operands must be contiguous")
    if (tuple(kf.shape) != (BH, F, N, d) or tuple(vf.shape) != (BH, F, N, d)
            or S != F * N):
        raise ValueError(f"bad shapes for the space-stage kernel: "
                         f"{[tuple(t.shape) for t in args]}")
    if d != HEAD_DIM:
        raise ValueError(f"space-stage kernel needs head dim {HEAD_DIM} "
                         f"(d={d})")
    _check_keys(N)
    out = torch.empty(BH, S, F, d, dtype=torch.bfloat16, device=q.device)
    kernel = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = kernel(q.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                     out.data_ptr(), BH, S, F, N, d, float(scale), stream)
    _build.check(err, "space_stage_bf16")
    LAUNCHES += 1
    return out


class _SpaceStage(torch.autograd.Function):
    """The kernel forward with the plain float32 backward (the JAX
    package's backward is plain XLA too, ``_space_stage_bwd``)."""

    @staticmethod
    def forward(ctx, q, kf, vf, scale):
        ctx.save_for_backward(q, kf, vf)
        ctx.scale = scale
        return _launch(q, kf, vf, scale)

    @staticmethod
    def backward(ctx, g):
        q, kf, vf = ctx.saved_tensors
        return (*space_stage_backward_reference(q, kf, vf, g, ctx.scale),
                None)


def space_stage(q_, k_, v_, f: int, scale: float, use_kernels: bool = True):
    """Drop-in for ``attn_ops.space_stage``: q_, k_, v_ [BH, S, d] with
    S = F * N -> [BH, S, F, d].

    A CPU tensor (or ``use_kernels=False``) takes the plain version, whose
    gradient is autograd's; a CUDA tensor launches the kernel (bf16,
    contiguous, head dim 64), whose gradient is the plain backward, or
    raises: a float32 operand raises ``TypeError``."""
    if q_.device.type == "cpu" or not use_kernels:
        return attn_ops.space_stage(q_, k_, v_, f, scale)
    if q_.device.type != "cuda":
        raise ValueError(f"no space-stage kernel for device {q_.device}")
    BH, S, d = q_.shape
    n = S // f
    return _SpaceStage.apply(q_, k_.reshape(BH, f, n, d),
                             v_.reshape(BH, f, n, d), scale)
