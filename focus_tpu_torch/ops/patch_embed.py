"""Non-overlapping 3D patch embed (tokenizer): the plain PyTorch version
and the wrapper of its CUDA kernel (``csrc/patch_embed.cu``), differentiable
through a ``torch.autograd.Function``.

Counterpart of ``focus_tpu/ops/pallas/patch_embed.py`` (``_tokens`` and its
custom VJP ``_tokens_bwd``) and of the reshape + matmul branch of
``PatchEmbed3D`` (``focus_tpu/models/motionformer.py``). The public function
keeps the JAX layout: video ``[B, T, H, W, C]`` and conv weight
``[kt, kh, kw, C, D]``. As in the JAX package, the backward is plain tensor
code (a patch gather and two matrix products); only the forward is a
kernel.
"""

import functools

import torch

from focus_tpu_torch.ops import _build

# kernel launches since the last reset (one per wrapper call on the card)
LAUNCHES = 0


def gather_patches(x, kernel):
    """x [B, T, H, W, C] -> patches [B, T'*H'*W', kt*kh*kw*C] in the JAX
    kernel layout (``_gather_patches_xla``)."""
    kt, kh, kw = kernel
    B, T, H, W, C = x.shape
    t_, h_, w_ = T // kt, H // kh, W // kw
    return x[:, : t_ * kt, : h_ * kh, : w_ * kw].reshape(
        B, t_, kt, h_, kh, w_, kw, C
    ).permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        B, t_ * h_ * w_, kt * kh * kw * C
    )


def patch_embed_reference(x, w, b, kernel, dtype=None):
    """Plain version: patch gather (reshape/permute) + matmul + bias.
    x [B, T, H, W, C]; w [kt, kh, kw, C, D]; b [D] -> [B, T'*H'*W', D] at
    ``dtype`` (default x's), float32 accumulation."""
    dtype = dtype or x.dtype
    patches = gather_patches(x, kernel)
    wm = w.reshape(-1, w.shape[-1]).to(dtype)
    out = torch.matmul(patches.to(dtype).float(), wm.float()).to(dtype)
    return out + b.to(dtype)


# the kernel's launch plan (csrc/patch_embed.cu)
BLOCK_ROWS = 128        # patch rows a block: two consumer warpgroups of 64
BLOCK_COLS = 256        # output columns a block: one m64n256 wgmma
STAGE_K = 64            # K a stage: one 128-byte row of a weight box
MAX_STAGES = 4
SMEM_LIMIT = 232_448    # shared memory a block may use on this card


def patch_embed_plan(video_shape, kernel, D, video_dtype=torch.float32):
    """The kernel's launch plan, as ``csrc/patch_embed.cu`` computes it for
    a video of ``video_shape`` [B, T, H, W, C] (its base 16-byte aligned,
    as PyTorch allocates it): the GEMM's M, K and D, the grid of
    (column block, row block), the ring's stages and shared memory, and the
    width of the video copies (elements, 16 bytes where the runs of kw * C
    values allow it)."""
    B, T, H, W, C = video_shape
    kt, kh, kw = kernel
    elem = torch.empty(0, dtype=video_dtype).element_size()
    M = B * (T // kt) * (H // kh) * (W // kw)
    K = kt * kh * kw * C
    a_bytes = BLOCK_ROWS * (STAGE_K + 8) * elem
    b_bytes = (BLOCK_COLS // 64) * STAGE_K * 128
    tail = BLOCK_ROWS * 8 + 256
    stages = min(MAX_STAGES, (SMEM_LIMIT - 1024 - tail) // (a_bytes + b_bytes))
    width = next((v for v in (16 // elem, 8 // elem, 4 // elem)
                  if v >= 1 and (kw * C) % v == 0 and (W * C) % v == 0), 1)
    return {"M": M, "K": K, "D": D,
            "grid": (-(-D // BLOCK_COLS), -(-M // BLOCK_ROWS)),
            "rows_per_block": BLOCK_ROWS, "cols_per_block": BLOCK_COLS,
            "threads": 384, "stages": stages, "k_steps": -(-K // STAGE_K),
            "smem_bytes": 1024 + stages * (a_bytes + b_bytes) + tail,
            "copy_elements": width, "copy_bytes": width * elem,
            "weight_row": -(-D // 8) * 8,
            "output_staging_bytes": 2 * 64 * (BLOCK_COLS + 8) * 2,
            "a_stage_bytes": a_bytes}


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    return _build.bind("patch_embed", "patch_embed_bf16", n_ptr=4, n_int=10)


def _launch(x, w, b, kernel, dtype):
    global LAUNCHES
    kt, kh, kw = kernel
    B, T, H, W, C = x.shape
    D = w.shape[-1]
    if dtype != torch.bfloat16:
        raise TypeError(f"patch-embed kernel computes in bfloat16, not {dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"patch-embed kernel reads float32 or bfloat16 video, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("patch-embed kernel needs a contiguous video")
    if tuple(w.shape) != (kt, kh, kw, C, D) or tuple(b.shape) != (D,):
        raise ValueError(f"weight {tuple(w.shape)} / bias {tuple(b.shape)} "
                         f"do not match kernel {kernel}, C={C}")
    if not (w.device == b.device == x.device):
        raise ValueError("video, weight and bias must be on one device")
    tp, hp, wp = T // kt, H // kh, W // kw
    # the kernel reads the weight [K, D] by TMA, whose rows are multiples of
    # 16 bytes from a 16-byte boundary: D is padded to a multiple of 8
    w2 = w.reshape(kt * kh * kw * C, D).to(torch.bfloat16)
    if D % 8:
        w2 = torch.nn.functional.pad(w2, (0, -D % 8))
    w2 = w2.contiguous()
    b2 = b.to(torch.bfloat16).contiguous()
    out = torch.empty(B, tp * hp * wp, D, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel_fn()(
            x.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            int(x.dtype == torch.bfloat16), B, T, H, W, C, kt, kh, kw, D,
            stream,
        )
    _build.check(err, "patch_embed_bf16")
    LAUNCHES += 1
    return out


def patch_embed_backward(x, w, dout, kernel, need_dx=True):
    """(dx, dw, db) of the patch embed (``_tokens_bwd``): dw = patches^T .
    dout and dx = dout . w^T scattered back to pixels, both at dout's dtype
    with a float32 result, db the float32 sum of dout. dx is None unless
    ``need_dx``; pixels outside whole patches get a zero gradient."""
    kt, kh, kw = kernel
    B, T, H, W, C = x.shape
    tp, hp, wp = T // kt, H // kh, W // kw
    D = w.shape[-1]
    dt = dout.dtype
    d2 = dout.reshape(-1, D)
    patches = gather_patches(x, kernel).to(dt).reshape(d2.shape[0], -1)
    dw = torch.matmul(patches.t(), d2).float().reshape(w.shape)
    db = dout.float().sum((0, 1))
    dx = None
    if need_dx:
        dpat = torch.matmul(d2, w.reshape(-1, D).to(dt).t()).float()
        dx = x.new_zeros(x.shape, dtype=torch.float32)
        dx[:, : tp * kt, : hp * kh, : wp * kw] = dpat.reshape(
            B, tp, hp, wp, kt, kh, kw, C
        ).permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, tp * kt, hp * kh,
                                                   wp * kw, C)
    return dx, dw, db


class _PatchEmbed(torch.autograd.Function):
    """The forward kernel (the plain version for a CPU tensor); the
    backward is ``patch_embed_backward`` on either device."""

    @staticmethod
    def forward(ctx, x, w, b, kernel, dtype):
        ctx.save_for_backward(x, w)
        ctx.kernel, ctx.b_dtype = kernel, b.dtype
        if x.device.type == "cpu":
            return patch_embed_reference(x, w, b, kernel, dtype)
        return _launch(x, w, b, kernel, dtype)

    @staticmethod
    def backward(ctx, dout):
        x, w = ctx.saved_tensors
        dx, dw, db = patch_embed_backward(x, w, dout, ctx.kernel,
                                          need_dx=ctx.needs_input_grad[0])
        if dx is not None:
            dx = dx.to(x.dtype)
        return dx, dw.to(w.dtype), db.to(ctx.b_dtype), None, None


def patch_embed_3d(x, w, b, kernel, dtype=None):
    """x [B, T, H, W, C] -> (tokens [B, T'*H'*W', D], (T', H', W')).

    ``w`` is the conv kernel [kt, kh, kw, C, D] (JAX layout), ``b`` [D];
    stride == kernel. ``dtype`` is the compute and output dtype (default
    x's). A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel, which reads the float32 or bf16 video as given and computes in
    bf16, or raises. The gradient is ``patch_embed_backward`` on both.
    """
    kt, kh, kw = kernel
    _, T, H, W, _ = x.shape
    thw = (T // kt, H // kh, W // kw)
    dtype = dtype or x.dtype
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no patch-embed kernel for device {x.device}")
    return _PatchEmbed.apply(x, w, b, tuple(kernel), dtype), thw
