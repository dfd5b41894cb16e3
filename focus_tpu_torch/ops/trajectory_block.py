"""Fused trajectory-attention core for the non-CLS tokens: the plain
PyTorch version and the wrapper of its CUDA kernel
(``csrc/trajectory_block.cu``).

Counterpart of ``focus_tpu/ops/pallas/trajectory_block.py``
(``fused_trajectory_core`` and its ``_xla_reference``), with the JAX
signature and layout: q ``[B, S, C]``, kf/vf ``[B, F, N, C]``, Wq2/Wk2
``[C, C]`` as ``[in, out]``, bq2/bk2 ``[C]``; S = F * N. Semantics follow
reference ``slowfast/models/attention.py:499-557`` with
``use_original_code=True``.
"""

import functools

import torch

from focus_tpu_torch.ops import _build
from focus_tpu_torch.ops import attention as attn_ops

# kernel launches since the last reset (one per wrapper call on the card)
LAUNCHES = 0

HEAD_DIM = 64  # the kernel's head dim; also C % 128 == 0, F <= 8, N <= 256,
# heads <= 16


def trajectory_core_reference(q, kf, vf, wq2, bq2, wk2, bk2, scale, heads):
    """Plain version: stage 1 (``space_stage``), the diagonal, q2, then
    stage 2 with the k2 projection on the query side
    (``temporal_stage_k2w``). bk2 is constant over frames and drops out."""
    del bk2
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
    q2 = q2 + bq2.to(q.dtype)
    return attn_ops.temporal_stage_k2w(q2, wk2, xs, F, scale, heads)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    return _build.bind("trajectory_block", "traj_core_bf16",
                       n_ptr=9, n_int=6, n_float=1)


def _launch(q, kf, vf, wq2, bq2, wk2, scale, heads):
    global LAUNCHES
    B, S, C = q.shape
    F, N = kf.shape[1], kf.shape[2]
    args = (q, kf, vf, wq2, bq2, wk2)
    if any(t.dtype != torch.bfloat16 for t in args):
        raise TypeError("trajectory kernel takes bfloat16 operands, got "
                        f"{[t.dtype for t in args]}")
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
    if (C != heads * HEAD_DIM or C % 128 or F > 8 or N > 256
            or heads > 16):
        raise ValueError(f"trajectory kernel needs head dim {HEAD_DIM}, "
                         f"C % 128 == 0, F <= 8, N <= 256, heads <= 16 "
                         f"(C={C}, heads={heads}, F={F}, N={N})")
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
    return out


def fused_trajectory_core(q, kf, vf, wq2, bq2, wk2, bk2, scale, heads):
    """Trajectory attention for the non-CLS tokens -> [B, S, C].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (bf16, contiguous, head dim 64) or raises."""
    if q.device.type == "cpu":
        return trajectory_core_reference(q, kf, vf, wq2, bq2, wk2, bk2,
                                         scale, heads)
    if q.device.type != "cuda":
        raise ValueError(f"no trajectory kernel for device {q.device}")
    return _launch(q, kf, vf, wq2, bq2, wk2, scale, heads)
