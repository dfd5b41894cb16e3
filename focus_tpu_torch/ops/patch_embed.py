"""Non-overlapping 3D patch embed (tokenizer): the plain PyTorch version
and the wrapper of its CUDA kernel (``csrc/patch_embed.cu``).

Counterpart of ``focus_tpu/ops/pallas/patch_embed.py`` and of the reshape +
matmul branch of ``PatchEmbed3D`` (``focus_tpu/models/motionformer.py``).
The public function keeps the JAX layout: video ``[B, T, H, W, C]`` and
conv weight ``[kt, kh, kw, C, D]``.
"""

import functools

import torch

from focus_tpu_torch.ops import _build

# kernel launches since the last reset (one per wrapper call on the card)
LAUNCHES = 0


def patch_embed_reference(x, w, b, kernel, dtype=None):
    """Plain version: patch gather (reshape/permute) + matmul + bias.
    x [B, T, H, W, C]; w [kt, kh, kw, C, D]; b [D] -> [B, T'*H'*W', D] at
    ``dtype`` (default x's), float32 accumulation."""
    kt, kh, kw = kernel
    B, T, H, W, C = x.shape
    t_, h_, w_ = T // kt, H // kh, W // kw
    dtype = dtype or x.dtype
    patches = x[:, : t_ * kt, : h_ * kh, : w_ * kw].reshape(
        B, t_, kt, h_, kh, w_, kw, C
    ).permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        B, t_ * h_ * w_, kt * kh * kw * C
    )
    wm = w.reshape(-1, w.shape[-1]).to(dtype)
    out = torch.matmul(patches.to(dtype).float(), wm.float()).to(dtype)
    return out + b.to(dtype)


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
    w2 = w.reshape(kt * kh * kw * C, D).to(torch.bfloat16).contiguous()
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


def patch_embed_3d(x, w, b, kernel, dtype=None):
    """x [B, T, H, W, C] -> (tokens [B, T'*H'*W', D], (T', H', W')).

    ``w`` is the conv kernel [kt, kh, kw, C, D] (JAX layout), ``b`` [D];
    stride == kernel. ``dtype`` is the compute and output dtype (default
    x's). A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel, which reads the float32 or bf16 video as given and computes in
    bf16, or raises.
    """
    kt, kh, kw = kernel
    _, T, H, W, _ = x.shape
    thw = (T // kt, H // kh, W // kw)
    dtype = dtype or x.dtype
    if x.device.type == "cpu":
        return patch_embed_reference(x, w, b, kernel, dtype), thw
    if x.device.type != "cuda":
        raise ValueError(f"no patch-embed kernel for device {x.device}")
    return _launch(x, w, b, tuple(kernel), dtype), thw
