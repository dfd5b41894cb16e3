"""Where the time of one trajectory-attention block goes, on one GPU: the
counterpart of ``scripts/profile_block.py``.

    python3 -m focus_tpu_torch.profile_block [variant ...] [--iters 15]

Variants (default ``full``), each a block at B=8, 12 heads, S=1568 tokens
(8 frames of 196, no CLS), C=768, bf16, zero weights, as the JAX script
builds them: ``full`` (stage 1 through the space-stage kernel, then
``proj_q`` over the own-frame aggregates, k2 = xs . Wk2 + bk2 over all of
them, the temporal stage with the aggregates as values, ``proj``, MLP),
``no_stage2`` (frame 0's aggregate in place of stage 2), ``no_mlp``,
``no_stage1`` (q broadcast over frames in place of stage 1) and
``stage1_only`` (the frame mean in place of stage 2). Each block is chained
on its own output ``--iters`` times and timed by CUDA events; one JSON line
per variant with the milliseconds per block and the space-stage launches
per block. ``--device cpu`` runs the plain versions at whatever size the
width options give, timed by the host clock (a check that the script runs,
not a device time).

``learned_v_stack`` builds the learned-v slice: a stack of
``TrajectoryAttentionBlock(use_original_code=False)`` at the flagship's
width with seeded init-scale weights, and its input.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from focus_tpu_torch.models.build import init_weights, resolve_device
from focus_tpu_torch.models.common import layer_norm, linear
from focus_tpu_torch.models.motionformer import Mlp, TrajectoryAttentionBlock
from focus_tpu_torch.ops import attention as attn_ops
from focus_tpu_torch.ops import trajectory_attention as ta

VARIANTS = ("full", "no_stage2", "no_mlp", "no_stage1", "stage1_only")
INIT_SCALE = 0.02


class BlockVariant(nn.Module):
    """One block of ``scripts/profile_block.py``'s ``BlockVariant``."""

    def __init__(self, variant, dim, heads, frames):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant {variant!r} not in {VARIANTS}")
        self.variant, self.heads, self.frames = variant, heads, frames
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj_q = nn.Linear(dim, dim)
        self.proj_kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x):
        v, h, nf = self.variant, self.heads, self.frames
        B, S, C = x.shape
        hd = C // h
        scale = hd ** -0.5
        q, k, vv = linear(layer_norm(x, self.norm1), self.qkv).chunk(3, -1)

        def split(t):
            return t.reshape(B, S, h, hd).transpose(1, 2).reshape(
                B * h, S, hd).contiguous()

        q, k, vv = map(split, (q, k, vv))
        if v == "no_stage1":
            xs = q.reshape(B, h, S, 1, hd).expand(B, h, S, nf, hd)
        else:
            xs = ta.space_stage(q, k, vv, nf, scale).reshape(B, h, S, nf, hd)
        xs = xs.permute(0, 2, 3, 1, 4).reshape(B, S, nf, C)
        if v == "stage1_only":
            out = xs.mean(dim=2)
        elif v == "no_stage2":
            out = xs[:, :, 0]
        else:
            q2 = linear(attn_ops.take_diagonal(xs, nf), self.proj_q)
            k2 = F.linear(xs, self.proj_kv.weight[:C].to(xs.dtype),
                          self.proj_kv.bias[:C].to(xs.dtype))
            out = attn_ops.temporal_stage(q2, k2, None, xs, nf, scale, h)
        x = x + linear(out, self.proj)
        if v != "no_mlp":
            x = x + self.mlp(layer_norm(x, self.norm2))
        return x


class LearnedVStack(nn.Module):
    """``depth`` learned-v trajectory blocks; ``forward(x)`` with x
    [B, 1 + F * P, D] (CLS first) at the compute dtype."""

    def __init__(self, dim, heads, depth, thw, dtype):
        super().__init__()
        self.thw, self.dtype, self.use_kernels = tuple(thw), dtype, True
        self.blocks = nn.ModuleList(
            TrajectoryAttentionBlock(dim, heads, qkv_bias=True,
                                     use_original_code=False)
            for _ in range(depth))

    def forward(self, x, train=False):
        for blk in self.blocks:
            x = blk(x, {}, self.thw, use_kernels=self.use_kernels,
                    train=train)
        return x


def learned_v_stack(device="cuda", batch=8, seed=0, tiny=False, hr=False):
    """(model, x): the learned-v slice, 12 blocks of D=768 and 12 heads at
    8 frames of 14 x 14 patches plus CLS, bf16 activations with float32
    weights drawn from N(0, 0.02^2) (seeded), and x [batch, 1569, 768] from
    numpy's RandomState(seed). ``hr``: the 336 crop's patch grid, 8 frames
    of 21 x 21 (N = 441 keys a frame), x [batch, 3529, 768]. ``tiny``: 2
    blocks of D=32, 4 heads, 2 frames of 2 x 2, float32, for the CPU (at
    every ``hr``)."""
    device = resolve_device(device)
    side = 21 if hr else 14
    dim, heads, depth, thw, dtype = ((32, 4, 2, (2, 2, 2), torch.float32)
                                     if tiny else
                                     (768, 12, 12, (8, side, side),
                                      torch.bfloat16))
    model = LearnedVStack(dim, heads, depth, thw, dtype).to(device).eval()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init_weights(model, gen, scale=INIT_SCALE)
    tokens = 1 + thw[0] * thw[1] * thw[2]
    x = np.random.RandomState(seed).randn(batch, tokens, dim)
    return model, torch.from_numpy(x.astype(np.float32)).to(device, dtype)


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", default=["full"])
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--patches", type=int, default=196,
                    help="tokens per frame")
    ap.add_argument("--dim", type=int, default=768)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    S = args.frames * args.patches
    x0 = np.random.RandomState(0).randn(args.batch, S, args.dim) * 0.02
    x0 = torch.from_numpy(x0.astype(np.float32)).to(device, dtype)
    results = []
    for v in args.variants:
        block = BlockVariant(v, args.dim, args.heads, args.frames).to(device)
        for p in block.parameters():
            nn.init.zeros_(p)
        with torch.no_grad():
            x = block(x0)  # warm-up (and the kernels' build)
            launches = ta.LAUNCHES
            if on_card:
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            for _ in range(args.iters):
                x = block(x)
            if on_card:
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end) / args.iters
            host_ms = 1e3 * (time.perf_counter() - t0) / args.iters
        row = {"variant": v, "batch": args.batch, "heads": args.heads,
               "tokens": S, "frames": args.frames, "dim": args.dim,
               "dtype": str(dtype).replace("torch.", ""),
               "space_stage_launches_per_block":
                   (ta.LAUNCHES - launches) / args.iters,
               "finite": bool(torch.isfinite(x).all())}
        if on_card:
            row.update(ms_per_block=ms, gpu=_smi())
        else:
            row.update(ms_per_block="not measured (CPU run)",
                       host_ms_per_block=host_ms)
        print(json.dumps(row), flush=True)
        results.append(row)
    return results


if __name__ == "__main__":
    main()
