"""Trajectory attention and joint space-time self-attention (counterpart of
``focus_tpu/ops/attention.py``).

Functional cores on projected q/k/v. Every contraction takes its operands
at their own dtype and accumulates in float32 (products of bf16 values are
exact in float32, so upcasting before the matmul is the same arithmetic as
a bf16 product with float32 accumulation); results are rounded back to the
operand dtype where the JAX functions round them. These functions are also
the plain version of the fused trajectory-core kernel
(``ops/trajectory_block.py``).

Trajectory attention (reference ``slowfast/models/attention.py:479-557``):
  stage 1 — every query token attends *within each frame* over all F
  frames' keys, producing per-frame aggregates x[b, q, f, d];
  stage 2 — temporal attention along the trajectory, with the query taken
  from the diagonal frame (the aggregate of the query's own frame).
Both forms of the reference are here: ``use_original_code=True`` (the
default, kept for checkpoint parity: the stage-2 values are the stage-1
aggregates, so the k2 projection reassociates onto the query side,
``temporal_stage_k2w``) and ``use_original_code=False`` (learned values
v2 from ``proj_kv``, ``temporal_stage``).
"""

import torch


def _f32(t):
    return t.to(torch.float32)


def space_stage(q_, k_, v_, f: int, scale: float):
    """Stage 1: per-frame spatial attention for all query tokens.

    q_, k_, v_: [BH, S, d] with S = F * P (no CLS). Returns x: [BH, S, F, d].
    """
    BH, S, d = q_.shape
    p = k_.shape[1] // f
    logits = torch.matmul(_f32(q_), _f32(k_).transpose(1, 2))
    logits = logits.reshape(BH, S, f, p) * scale
    attn = torch.softmax(logits, dim=-1).to(q_.dtype)
    v_f = v_.reshape(BH, f, p, d)
    out = torch.einsum("bqfn,bfnd->bqfd", _f32(attn), _f32(v_f))
    return out.to(q_.dtype)


def take_diagonal(x, f: int):
    """x: [B, S, F, d] with S = F * P -> diagonal frame aggregate [B, S, d]
    (reference attention.py:533-535)."""
    B, S, F, d = x.shape
    p = S // f
    xg = x.reshape(B, f, p, F, d)
    diag = torch.diagonal(xg, dim1=1, dim2=3)  # [B, p, d, f]
    return diag.permute(0, 3, 1, 2).reshape(B, S, d)


def temporal_stage(q2, k2, v2, x, f: int, scale: float, h: int,
                   use_original_code: bool = True):
    """Stage 2: attention over the F per-frame aggregates.

    q2: [B, S, C] (projected diagonal), k2/v2: [B, S, F, C], x: [B, S, F, C].
    The values are x (``use_original_code``) or v2. Returns [B, S, C].
    """
    B, S, C = q2.shape
    d = C // h
    q2h = (q2.reshape(B, S, h, d) * scale).to(q2.dtype)
    k2h = k2.reshape(B, S, f, h, d)
    logits = torch.einsum("bshd,bsfhd->bhsf", _f32(q2h), _f32(k2h))
    attn = torch.softmax(logits, dim=-1).to(q2.dtype)
    src = x if use_original_code else v2
    srch = src.reshape(B, S, f, h, d)
    out = torch.einsum("bhsf,bsfhd->bshd", _f32(attn), _f32(srch))
    return out.to(q2.dtype).reshape(B, S, C)


def temporal_stage_k2w(q2, wk2, xs, f: int, scale: float, h: int):
    """Stage 2 with the k2 projection reassociated onto the query side
    (``use_original_code=True`` semantics).

    logits[., f] = q2_h . (xs_f @ Wk2[:, h]) = (q2_h @ Wk2[:, h]^T) . xs_f;
    the k2 bias is constant over f and drops out of the softmax.

    q2: [B, S, C]; wk2: [C, C] (k half of proj_kv, [in, out]);
    xs: [B, S, F, C]. Returns [B, S, C].
    """
    B, S, C = q2.shape
    d = C // h
    q2h = q2.reshape(B, S, h, d)
    wk2h = wk2.to(q2.dtype).reshape(C, h, d).permute(1, 0, 2)  # [h, C, d]
    g = torch.einsum("bshd,hcd->bshc", _f32(q2h), _f32(wk2h)).to(q2.dtype)
    logits = torch.einsum("bshc,bsfc->bhsf", _f32(g), _f32(xs)) * scale
    attn = torch.softmax(logits, dim=-1).to(q2.dtype)
    srch = xs.reshape(B, S, f, h, d)
    out = torch.einsum("bhsf,bsfhd->bshd", _f32(attn), _f32(srch))
    return out.to(q2.dtype).reshape(B, S, C)


def cls_attention(cls_q, k, v, scale: float):
    """CLS token attends over everything (reference attention.py:512-519).
    cls_q: [BH, 1, d], k/v: [BH, N, d] -> [BH, 1, d]. The attention weights
    are applied at the kv dtype, as in the JAX function."""
    qs = (cls_q * scale).to(cls_q.dtype)
    logits = torch.matmul(_f32(qs), _f32(k).transpose(1, 2))
    attn = torch.softmax(logits, dim=-1).to(k.dtype)
    return torch.matmul(_f32(attn), _f32(v)).to(cls_q.dtype)


def joint_attention(q, k, v, scale: float):
    """Vanilla joint space-time attention (reference attention.py:355-385).
    q/k/v: [B, H, N, d]."""
    logits = torch.matmul(_f32(q), _f32(k).transpose(-1, -2)) * scale
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(_f32(attn), _f32(v)).to(q.dtype)
