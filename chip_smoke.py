"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Run from the repository root:  python3 chip_smoke.py

Phases (one JSON line each; any failure exits non-zero):
  1. environment and build: the card's name and power limit, TF32 off for
     every comparison, the CUDA kernels built from focus_tpu_torch/csrc/;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes its main path gives it (plus extreme stage-1 logits for the
     trajectory core's forward and backward, ragged and small shapes, the
     xs and q2 the forward writes, the patch embed at the 336 crop, T = 15
     and other C and D, and other row counts, step indices and a narrow
     decoder for the decode step), the redesigned kernels twice bit-equal;
     kernel, plain and (where one exists) library times by CUDA events, the
     patch embed and F.conv3d in turns on the same bf16 video;
  3. the port's layers against the golden fixtures of the reference
     (ORViT-MF, and STEVE's dVAE, slot attention and transformer decoder;
     plain path, float32, on the card);
  4. the flagship slice: ORViT-Motionformer SSv2 16x224 (D=768, 12 layers,
     12 heads, ORViT at [1, 6, 10], bf16) at batch 8 through the kernels,
     with launch counts, throughput, peak memory, and the probabilities held
     against the same model and weights on the plain path;
  5. the training slice: the flagship train step (forward, the trajectory
     core's backward kernel, AdamW) through ``train_entry`` at batch 8, with
     launch counts per step, train clips per second, peak memory, finite
     gradients, and at batch 2 the loss, every parameter's gradient and the
     parameters after one step held against the plain path in float32 from
     the same weights and batch (the bf16 plain path beside it);
  6. the STEVE slice: encode + KV-cached rollout + dVAE decode at full width
     (64 px, 256 tokens, decoder D=2048 with 8 blocks, vocabulary 4096,
     bf16) at 32 and 128 rollout rows through the fused decode step, the
     rollout one replay of its captured CUDA graph, with launch counts
     (steps, and device kernels as the C function counts them, every one
     with the PDL attribute), frames per second, the time split, the same
     reconstructions launched step by step and the unfused module rollout
     beside it, the graph's ids and logits bit-equal to the step-by-step
     rollout's, and the logits and token ids held against the plain path;
  7. the W8A8 serving matrix: the flagship forward at batch 8, exact-erf
     bf16 and the labeled variants TPU.FAST_GELU, TPU.INT8_SERVING and both,
     one after the other (launch counts, clips per second, peak memory,
     probabilities against the same variant on the plain path and against
     the exact-erf bf16 model), and STEVE's
     rollout through the W8A8 decode step at 32 and 128 rows (frames per
     second, launch counts, time split, ids against the W8A8 plain path);
  8. the trajectory core's forward versions: the flagship forward at batch
     8 under FWD_VERSION 4, 3, 7, 5 and 6 (clips per second, peak memory, 12
     launches of the chosen kernel per forward and none of the others, the
     probabilities against the plain path), after the v3, v7, v5 and v6
     kernels are held against their step-by-step plain versions in phase 2
     (v3 and v7 also against the plain trajectory core, whose function they
     compute; and their xs and q2 against the plain stage 1 in their
     rounding: kernels 3 and 4 are kernel 1's three launches in its
     rounding mode V3); the train step of phase 5 runs under FWD_VERSION 3
     and 7 too;
  9. the learned-v slice: 12 learned-v trajectory blocks
     (``use_original_code=False``) at D=768 on x [8, 1569, 768] bf16
     through the space-stage kernel (ms per stack, 12 launches per stack,
     peak memory, the output against the plain path), the same stack at
     the 336 crop (x [4, 3529, 768], N = 441, kernel 8's chunked form),
     and at batch 2 one forward and backward against the float32 plain
     path;
 10. the HR-336 EPIC-Kitchens eval forward (ORViT-MF-HR, EK100 16x336,
     verb and noun heads, N = 441 keys a frame, 445 in the ORViT blocks):
     kernel 1 at N > 256 (its chunked stage 1) at N = 441 and 445 (B=4),
     257 and 512 (B=2) and on the extreme inputs at N = 441 against its
     plain version, two calls bit-equal, three device kernels a call;
     ``hr_entry(batch=4)`` at full width and depth (12 kernel-1 launches a
     forward, clips per second, peak memory, verb and noun probabilities
     against the plain path); kernels 1 and 3 to 8 refusing N = 513
     before any launch;
 11. the HR-336 EPIC-Kitchens train step: ``hr_train_entry(batch=4)`` at
     full width and depth under EK_loss (12 kernel-1 and 12 kernel-7 calls
     and 1 patch embed a step asserted, train clips per second, peak
     memory, finite loss and gradients; at batch 2 the loss, gradients and
     parameters after a step against the float32 plain path), after kernel
     7 is held at N = 441, 445, 257 and 512 and on an extreme input at N =
     441 in phase 2 (its dq kernel's chunked form);
 12. the HR-336 forward under every FWD_VERSION: ``hr_entry(batch=4)``
     under 4, 3, 7, 5 and 6 on one model (12 launches of the version's
     kernel a forward, the probabilities against the plain path), then one
     ``hr_train_entry`` step at batch 2 under each (launch counts, finite
     loss and gradients, v3 and v7's loss against version 4's), after
     kernels 3 to 6 and 8 are held past 256 keys a frame (their chunked
     forms: N = 441 and 445 at B = 4, 257 and 512 at B = 2, extreme inputs
     at 441) in phase 2;
 13. the multi-view test path (``tools.run_net`` -> ``engine.tester.test``:
     the loader, the checkpoint reader, the test meters) on in-script test
     splits: the HR-336 EK model through ``configs/ORViT/EK_ORVIT_MF_HR.yaml``,
     2 videos x 10 views x 3 crops at batch 16, and the flagship SSv2, 4
     videos x 1 view x 3 crops at batch 8, each from a checkpoint written
     first: every clip counted once, the checkpoint's weights in the model,
     12 kernel-1 and 1 kernel-2 launches a batch, the ensembled
     probabilities against a direct loop through ``EvalForward`` (1e-3),
     the loop's and the forward's clips per second and the loop's share
     waiting for batches.
Then the kernel table, the card's nvidia-smi line, and the result line.
The script imports nothing of JAX.
"""

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"  # every phase runs on the card
# H100 SXM data sheet: dense bf16 and int8 tensor-core rates, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12
# kernel vs plain float32 on the same bf16 inputs: the kernels round their
# intermediates (stage-1 weights, xs, q2, g, stage-2 weights; the patch-embed
# output) to bf16, ~2^-9 relative each, which gives ~0.5% of the output's
# scale at these widths; the bound allows 4x that.
KERNEL_TOL_REL = 2e-2
# slice, kernel path vs plain path (both bf16): probabilities near 1/174
SLICE_PROB_ATOL = 1e-4
SLICE_TOP1_MIN_SHARE = 0.75
FIXTURE_ATOL = 2e-4  # the CPU tests' tolerance for this fixture
TIMED_ITERS = 20
SLICE_ITERS = 5
# decode step, kernel vs plain version on the same bf16 inputs: both round at
# the same points and accumulate in float32, in another order, so a value
# near a rounding boundary can land one bf16 step (2^-8 relative) apart and
# carry through the remaining layers; the bound allows a few such steps
AR_TOL_REL = 2e-2
STEVE_ITERS = 2
AR_STEPS = (0, 1, 31, 32, 33, 128, 255)
# W8A8 decode step, kernel vs plain version on the same inputs: the bf16
# causes above, and where an activation lands next to a rounding boundary of
# its code (a bf16 step apart in xn, ctx or the hidden) the code flips and
# moves that output by one quantum, s_row * s_col * |w code| <= amax_a *
# amax_w / 127, which then carries through the remaining layers like a bf16
# step; the bound allows 1.5x the bf16 one
AR_W8A8_TOL_REL = 3e-2
# serving variants against the exact-erf bf16 model on the same weights
# (tests/test_int8_serving.py:81)
VARIANT_PROB_ATOL = 0.05
# trajectory backward, kernel vs plain float32 on the same bf16 inputs: the
# kernel adds bf16 rounding of the stage-2 P, dxs and the stage-1 weights of
# dv to the forward's; each gradient's relative L2 error must stay within 1e-2
BWD_REL_L2 = 1e-2
# kernels 3 and 4's xs against the plain stage 1 in their rounding on the
# same bf16 operands (trajectory_core_v3_stage1_reference: float32 sums,
# p rounded before it is normalised): both round at the same points, so an
# element differs only where exp2 or the sum order moves a value across a
# rounding boundary, and mean|err| / mean|ref| stays far below the 2^-9 of
# a changed rounding point. On an H100 (B=8, N=196 and 200, both extreme
# inputs) kernels 3 and 4 read 6.5e-7 to 2.0e-6 and kernel 1's xs (p
# normalised, then rounded) 2.1e-3 to 2.2e-3 against the same reference;
# the bound lies near the geometric mean of the two, and the check asserts
# that kernel 1 reads above it on every case
V3_XS_MEAN_REL = 6e-5
TRAIN_WARMUP, TRAIN_ITERS = 2, 5
# train step at batch 2, kernel path (bf16) vs plain path (float32) from the
# same weights and batch
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_COS = 0.99
TRAIN_GRAD_REL_L2 = 5e-2
TRAIN_PARAM_REL_L2 = 1e-3
# where the bf16 plain path itself is farther than TRAIN_GRAD_REL_L2 from the
# float32 one (the stage-2 weights at init, whose gradient is a difference of
# near-equal terms that the bf16 rounding of xs perturbs), the kernel path
# may be at most this factor farther than it
BF16_SLACK = 1.25


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup=3, iters=TIMED_ITERS):
    """Median of per-call CUDA-event times after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_ms_back_to_back(fn, warmup=3, iters=TIMED_ITERS):
    """Mean time of ``iters`` calls issued back to back between two CUDA
    events: the host's per-call work overlaps the card's, so this reads the
    device time wherever the host issues faster than the card runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, int8_ops=0):
    """Least time (ms) and what binds it: bf16 operations and int8
    operations at their peak rates, or the bytes at the memory rate."""
    t_ops = flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_build():
    from focus_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = _build.build_all()
    ptxas = {}
    for name in _build.SOURCES:
        log = os.path.join(_build.BUILD_DIR, f"{name}.log")
        if os.path.exists(log):
            with open(log) as f:
                ptxas[name] = [ln.strip() for ln in f
                               if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "ok": True, "seconds": round(seconds, 3),
          "sources": [f"focus_tpu_torch/csrc/{n}.cu" for n in _build.SOURCES],
          "nvcc_flags": list(_build.NVCC_FLAGS), "ptxas": ptxas,
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32}})


def core_inputs(B, N, gen, F=8, C=768):
    S = F * N
    dev = DEV

    def rnd(*shape, sc=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * sc).bfloat16()

    return [rnd(B, S, C), rnd(B, F, N, C), rnd(B, F, N, C),
            rnd(C, C, sc=3 * C ** -0.5), rnd(C, sc=0.1),
            rnd(C, C, sc=3 * C ** -0.5), rnd(C, sc=0.1)]


def extreme_inputs(sign, mag, gen, B=1, F=8, N=196, C=768, heads=12):
    """tests/test_fused_block.py:_extreme_inputs at the kernel's widths:
    stage-1 logits of ~sign*mag nats after the scale."""
    S, dev = F * N, DEV
    scale = (C // heads) ** -0.5
    qdir = torch.randn(B, S, C, generator=gen, device=dev)
    qdir = qdir / qdir.norm(dim=-1, keepdim=True)
    amp = (mag / scale) ** 0.5
    q = qdir * amp * sign
    kf = (qdir.reshape(B, F, N, C)[:, :1, :1].expand(B, F, N, C) * amp
          + torch.randn(B, F, N, C, generator=gen, device=dev) * 0.01)
    vf = torch.randn(B, F, N, C, generator=gen, device=dev) * 0.2
    wq2 = torch.randn(C, C, generator=gen, device=dev) * 0.1
    bq2 = torch.randn(C, generator=gen, device=dev) * 0.1
    wk2 = torch.randn(C, C, generator=gen, device=dev) * 0.1
    bk2 = torch.zeros(C, device=dev)
    return [t.bfloat16().contiguous() for t in (q, kf, vf, wq2, bq2, wk2, bk2)]


def core_flops(B, S, F, N, C):
    # stage-1 QK^T and PV, q2 and g projections, stage-2 logits and sum
    return 2 * B * S * F * N * C * 2 + 2 * B * S * C * C * 2 \
        + 2 * B * S * F * C * (C // 64) + 2 * B * S * F * C


def k2v_flops(B, S, F, N, C):
    """Operations that kernels 5 and 6's function needs in its k2v form:
    the k2v and q2 GEMMs, and QK, PV and P . k2v over all F N keys with
    the stage-2 logits' row dots and the mix. The own-frame aggregates are
    not counted apart: the pass's PV over each row's own frame forms them
    (csrc/trajectory_k2v.cuh forms them once more, in a launch of their
    own, for q2; ``own_frame_flops``)."""
    return 2 * B * F * N * C * C + 2 * B * S * C * C \
        + 6 * B * S * F * N * C + 2 * 2 * B * S * F * C


def own_frame_flops(B, S, N, C):
    """QK and PV of each row's own frame: the own-frame launch of kernels 5
    and 6, which the design does beside ``k2v_flops``."""
    return 4 * B * S * N * C


def check_close(name, out, ref, rel=KERNEL_TOL_REL):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    ok = bool(torch.isfinite(out).all()) and err <= rel * scale
    if not ok:
        raise AssertionError(f"{name}: max|err| {err:.3e} > {rel} x max|ref| "
                             f"{scale:.3e} (or non-finite output)")
    return err, scale


def check_stage1_outputs(tb, args, scale, heads, tag):
    """xs and q2 that kernel 1 writes on the way (what kernel 7 reads),
    against the plain stage 1 and q2 in float32 on the same inputs, and a
    second call bit-equal to the first (out, xs and q2)."""
    first = tb._launch(*args[:6], scale, heads)
    second = tb._launch(*args[:6], scale, heads)
    xs_ref, q2_ref = tb.trajectory_core_stage1_reference(
        *[a.float() for a in args[:5]], scale, heads)
    torch.cuda.synchronize()
    xs_err, xs_max = check_close(f"trajectory_block {tag} xs", first[1], xs_ref)
    q2_err, q2_max = check_close(f"trajectory_block {tag} q2", first[2], q2_ref)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    if not same:
        raise AssertionError(f"trajectory_block {tag}: two calls differ")
    return {"xs_max_abs_err": xs_err, "xs_max_abs_ref": xs_max,
            "q2_max_abs_err": q2_err, "q2_max_abs_ref": q2_max,
            "two_calls_bitwise_equal": same}


def mean_rel(out, ref):
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().mean() / ref.abs().mean()).item()


def check_v3_stage1_outputs(tb, version, args, scale, heads, tag):
    """xs and q2 that kernel 3 or 4 writes on the way (what kernel 7 reads)
    against trajectory_core_v3_stage1_reference on the same bf16 operands:
    max|err| within KERNEL_TOL_REL x max|ref| (xs and q2); at N <= 256
    xs's mean|err| / mean|ref| within V3_XS_MEAN_REL, which kernel 1's xs
    (the other rounding of the stage-1 weights) must exceed on the same
    inputs; past 256 keys a frame, where stage 1 is kernel 1's chunked
    kernel in both roundings, xs and q2 bit-equal to kernel 1's and xs's
    mean|err| / mean|ref| within V3_XS_MEAN_REL of the chunked stage 1's
    plain mirror (the rounding of chunk 0's weights against chunk 0's max
    moves xs ~1e-3 from the V3 reference there); and a second call
    bit-equal to the first (out, xs and q2)."""
    name = f"trajectory_block_v{version}"
    launch = {3: tb._launch_v3, 7: tb._launch_v7}[version]
    first = launch(*args[:6], scale, heads)
    second = launch(*args[:6], scale, heads)
    v4 = tb._launch(*args[:6], scale, heads)
    xs_ref, q2_ref = tb.trajectory_core_v3_stage1_reference(*args[:5], scale,
                                                            heads)
    torch.cuda.synchronize()
    xs_err, xs_max = check_close(f"{name} {tag} xs", first[1], xs_ref)
    q2_err, q2_max = check_close(f"{name} {tag} q2", first[2], q2_ref)
    xs_mean, v4_mean = mean_rel(first[1], xs_ref), mean_rel(v4[1], xs_ref)
    report = {"xs_max_abs_err": xs_err, "xs_max_abs_ref": xs_max,
              "xs_mean_err_rel": xs_mean, "kernel_1_xs_mean_err_rel": v4_mean,
              "q2_max_abs_err": q2_err, "q2_max_abs_ref": q2_max}
    if args[1].shape[2] > tb.MAX_KEYS:
        mirror_xs = tb._chunked_xs(*args[:3], scale, heads)
        report["xs_mean_err_rel_vs_chunked_mirror"] = mean_rel(first[1],
                                                              mirror_xs)
        report["xs_q2_bitwise_equal_to_kernel_1"] = (
            torch.equal(first[1], v4[1]) and torch.equal(first[2], v4[2]))
        del mirror_xs
        if not (report["xs_q2_bitwise_equal_to_kernel_1"]
                and report["xs_mean_err_rel_vs_chunked_mirror"]
                <= V3_XS_MEAN_REL):
            raise AssertionError(f"{name} {tag}: xs / q2 not kernel 1's, or "
                                 f"off the chunked mirror ({report})")
    elif not xs_mean <= V3_XS_MEAN_REL < v4_mean:
        raise AssertionError(
            f"{name} {tag} xs: mean|err| / mean|ref| {xs_mean:.3e}, kernel "
            f"1's {v4_mean:.3e}; the bound {V3_XS_MEAN_REL} must lie "
            "between them")
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    if not same:
        raise AssertionError(f"{name} {tag}: two calls differ")
    report["two_calls_bitwise_equal"] = same
    return report


def phase_trajectory_kernel():
    from focus_tpu_torch.ops import trajectory_block as tb

    heads, scale = 12, 64 ** -0.5
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    cases, errs = [], []
    timing = None
    # B=2 N=65: ragged query tiles (S = 520) and keys padded 65 -> 128
    for B, N in ((2, 196), (2, 200), (1, 196), (2, 65), (8, 196), (8, 200)):
        args = core_inputs(B, N, gen)
        out = tb.fused_trajectory_core(*args, scale, heads)
        ref = tb.trajectory_core_reference(*[a.float() for a in args],
                                           scale, heads)
        torch.cuda.synchronize()
        err, ref_max = check_close(f"trajectory_block B={B} N={N}", out, ref)
        errs.append(err)
        case = {"B": B, "S": 8 * N, "N": N, "max_abs_err": err,
                "max_abs_ref": ref_max,
                **check_stage1_outputs(tb, args, scale, heads,
                                       f"B={B} N={N}")}
        if B == 8:
            S, C = 8 * N, 768
            case["kernel_ms"] = time_ms(
                lambda: tb.fused_trajectory_core(*args, scale, heads))
            case["kernel_ms_back_to_back"] = time_ms_back_to_back(
                lambda: tb.fused_trajectory_core(*args, scale, heads))
            case["plain_ms"] = time_ms(
                lambda: tb.trajectory_core_reference(*args, scale, heads),
                warmup=1, iters=TIMED_ITERS)
            case["bound_ms"], case["bound_by"] = bound(
                core_flops(B, S, 8, N, C), nbytes(*args) + nbytes(out))
            case["xs_scratch_bytes"] = B * S * 8 * C * 2
            case["plan"] = tb.trajectory_core_plan(B, S, 8, N, heads)
            if N == 196:
                timing = case
        del args, out, ref
        cases.append(case)
    # the other shapes the kernel takes: 16 heads (at M = 7200 in 64-row
    # blocks with two stage-2 ring slots), 2 heads, F = 4 and F = 1 (frames
    # past F read as zero)
    for B, N, F, h in ((1, 256, 8, 16), (4, 225, 8, 16), (2, 50, 4, 2),
                       (1, 196, 1, 12)):
        args = core_inputs(B, N, gen, F=F, C=64 * h)
        out = tb.fused_trajectory_core(*args, scale, h)
        ref = tb.trajectory_core_reference(*[a.float() for a in args],
                                           scale, h)
        torch.cuda.synchronize()
        tag = f"B={B} N={N} F={F} heads={h}"
        err, ref_max = check_close(f"trajectory_block {tag}", out, ref)
        errs.append(err)
        cases.append({"B": B, "N": N, "F": F, "heads": h, "max_abs_err": err,
                      "max_abs_ref": ref_max,
                      **check_stage1_outputs(tb, args, scale, h, tag)})
    for sign, mag in ((-1.0, 25.0), (-1.0, 60.0), (1.0, 50.0)):
        args = extreme_inputs(sign, mag, gen)
        out = tb.fused_trajectory_core(*args, scale, heads)
        ref = tb.trajectory_core_reference(*[a.float() for a in args],
                                           scale, heads)
        torch.cuda.synchronize()
        err, ref_max = check_close(f"trajectory_block extreme {sign * mag}",
                                   out, ref)
        errs.append(err)
        cases.append({"extreme_logit_nats": sign * mag, "max_abs_err": err,
                      "max_abs_ref": ref_max,
                      **check_stage1_outputs(tb, args, scale, heads,
                                             f"extreme {sign * mag}")})
    emit({"phase": "kernel", "name": "trajectory_block", "ok": True,
          "tolerance": f"max|err| <= {KERNEL_TOL_REL} x max|ref| (bf16 "
                       "intermediates vs plain float32 on the same inputs), "
                       "for out and for the xs and q2 the kernel writes; two "
                       "calls bit-equal",
          "library_ms": None,
          "library_note": "no single PyTorch call computes trajectory attention",
          "cases": cases})
    return {"name": "trajectory_block", "route": "cuda",
            "source": "focus_tpu_torch/csrc/trajectory_block.cu",
            "replaces": "focus_tpu/ops/pallas/trajectory_block.py:246",
            "max_abs_err": max(errs), "ms": timing["kernel_ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"], "library_ms": None,
            "ms_back_to_back": timing["kernel_ms_back_to_back"],
            "ms_note": "ms: the median of calls each from an idle card (the "
                       "host's launch work included); ms_back_to_back: 20 "
                       "calls issued back to back between two events, the "
                       "mean",
            "shape": "B=8 S=1568 N=196 F=8 C=768 heads=12 (S=1600: "
                     f"{cases[5]['kernel_ms']:.4f} ms)"}


def core_bwd_flops(B, S, F, N, C, heads):
    # the TPU kernel's form: five stage-1 products (logits, dP, dv, dq, dk),
    # five C x C products (g, dq2, dWk2, dWq2, dd), three stage-2
    # contractions over F x C per head (logits, dg, the dxs logit term)
    return 5 * 2 * B * S * F * N * C + 5 * 2 * B * S * C * C \
        + 3 * 2 * B * S * F * C * heads


def grad_errors(name, got, ref):
    """max|err|, max|ref| and the relative L2 error of one gradient; raises
    past max|err| <= KERNEL_TOL_REL x max|ref| or BWD_REL_L2."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    rel_l2 = ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()
    if not (bool(torch.isfinite(got).all()) and err <= KERNEL_TOL_REL * scale
            and rel_l2 <= BWD_REL_L2):
        raise AssertionError(
            f"{name}: max|err| {err:.3e} vs {KERNEL_TOL_REL} x max|ref| "
            f"{scale:.3e}, rel L2 {rel_l2:.3e} vs {BWD_REL_L2} (or non-finite)")
    return {"max_abs_err": err, "max_abs_ref": scale, "rel_l2": rel_l2}


GRAD_NAMES = ("dq", "dkf", "dvf", "dwq2", "dbq2", "dwk2")


# device kernels one backward call launches (csrc/trajectory_block_bwd.cu:
# the stage-2 row kernel, dd, dWq2, dWk2, dxs, the sums, stage-1 dq, dk/dv)
BWD_DEVICE_LAUNCHES_PER_CALL = 8


def check_bwd_scratch(scratch, B, S, F, C):
    """The backward's scratch holds neither the first design's float32
    Y = xs . Wk2 nor its P [B S F, C], nor any float32 tensor of that size."""
    if "y" in scratch or "pmat" in scratch:
        raise AssertionError(f"backward scratch still holds {sorted(scratch)}")
    big = [name for name, t in scratch.items()
           if t.dtype == torch.float32 and t.numel() >= B * S * F * C]
    if big:
        raise AssertionError(f"float32 [B S F, C] scratch in the backward: {big}")
    return sorted(scratch)


def check_core_backward(tb, args, dout, scale, heads, tag):
    """The backward kernel (from the forward kernel's xs and q2) against
    trajectory_core_backward_reference in float32 on the same inputs; the
    kernel's dxs and dq2 against the reference's, for information; a second
    call on the same inputs must give the same bits; its scratch must hold
    no float32 [B S F, C] tensor."""
    q, kf, vf, wq2, bq2, wk2, bk2 = args
    _, xs, q2 = tb._launch(q, kf, vf, wq2, bq2, wk2, scale, heads)
    scratch = {}
    before = tb.BWD_DEVICE_LAUNCHES
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = tb._launch_backward(q, kf, vf, wq2, bq2, wk2, dout, xs, q2, scale,
                              heads, scratch=scratch)
    torch.cuda.synchronize()
    call_peak = torch.cuda.max_memory_allocated() - resident
    launched = tb.BWD_DEVICE_LAUNCHES - before
    again = tb._launch_backward(q, kf, vf, wq2, bq2, wk2, dout, xs, q2, scale,
                                heads)
    bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
    if not bit_equal:
        raise AssertionError(f"{tag}: two backward calls on the same inputs "
                             "differ")
    del again
    inter = {}
    ref = tb.trajectory_core_backward_reference(
        *[a.float() for a in args], dout.float(), scale, heads,
        intermediates=inter)
    torch.cuda.synchronize()
    B, S, C = q.shape
    case = {"case": tag, "device_launches": launched,
            "bit_equal_second_call": bit_equal,
            "scratch": check_bwd_scratch(scratch, B, S, kf.shape[1], C),
            "scratch_gb": nbytes(*scratch.values()) / 1e9,
            "call_peak_gb": call_peak / 1e9}
    for name, g, r in zip(GRAD_NAMES, got, ref):
        case[name] = grad_errors(f"{tag} {name}", g, r)
    for name in ("dxs", "dq2"):
        d = (scratch[name].float() - inter[name]).abs().max().item()
        case[f"{name}_max_abs_err"] = d
        case[f"{name}_max_abs_ref"] = inter[name].abs().max().item()
    return case, xs, q2


def phase_trajectory_backward():
    from focus_tpu_torch.ops import trajectory_block as tb

    heads, scale, C, F = 12, 64 ** -0.5, 768, 8
    gen = torch.Generator(device=DEV)
    gen.manual_seed(3)
    cases, timing = [], []
    for N in (196, 200):
        B, S = 8, F * N
        args = core_inputs(B, N, gen)
        dout = (torch.randn(B, S, C, generator=gen, device=DEV) * 0.1).bfloat16()
        case, xs, q2 = check_core_backward(tb, args, dout, scale, heads,
                                           f"B={B} N={N}")
        q, kf, vf, wq2, bq2, wk2, bk2 = args
        kernel_ms = time_ms(lambda: tb._launch_backward(
            q, kf, vf, wq2, bq2, wk2, dout, xs, q2, scale, heads))
        plain_ms = time_ms(lambda: tb.trajectory_core_backward_reference(
            *args, dout, scale, heads), warmup=1, iters=3)
        ins = nbytes(q, kf, vf, wq2, wk2, dout, xs, q2)
        outs = nbytes(q, kf, vf) + 4 * (2 * C * C + C)
        bound_ms, bound_by = bound(core_bwd_flops(B, S, F, N, C, heads),
                                   ins + outs)
        timing.append({"B": B, "S": S, "N": N, "kernel_ms": kernel_ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by})
        cases.append(case)
        del args, dout, xs, q2
        torch.cuda.empty_cache()
    for sign, mag in ((-1.0, 60.0), (1.0, 50.0)):
        args = extreme_inputs(sign, mag, gen)
        dout = (torch.randn(args[0].shape, generator=gen, device=DEV)
                * 0.1).bfloat16()
        cases.append(check_core_backward(tb, args, dout, scale, heads,
                                         f"extreme {sign * mag}")[0])
    # N in (208, 256]: frames padded to 256 keys, the dq kernel's other form
    args = core_inputs(2, 232, gen)
    dout = (torch.randn(args[0].shape, generator=gen, device=DEV)
            * 0.1).bfloat16()
    cases.append(check_core_backward(tb, args, dout, scale, heads,
                                     "B=2 N=232")[0])
    del args, dout
    torch.cuda.empty_cache()
    # N > 256: the dq kernel's chunked form, at the HR-336 shapes (N = 441
    # and 445 at B = 4, timed) and the narrowest and widest chunked N
    for B, N in HR_KERNEL_CASES:
        S = F * N
        args = core_inputs(B, N, gen)
        dout = (torch.randn(B, S, C, generator=gen, device=DEV)
                * 0.1).bfloat16()
        case, xs, q2 = check_core_backward(tb, args, dout, scale, heads,
                                           f"B={B} N={N}")
        cases.append(case)
        if B == HR_BATCH:
            q, kf, vf, wq2, bq2, wk2, bk2 = args

            def call():
                tb._launch_backward(q, kf, vf, wq2, bq2, wk2, dout, xs, q2,
                                    scale, heads)

            ins = nbytes(q, kf, vf, wq2, wk2, dout, xs, q2)
            outs = nbytes(q, kf, vf) + 4 * (2 * C * C + C)
            bound_ms, bound_by = bound(core_bwd_flops(B, S, F, N, C, heads),
                                       ins + outs)
            timing.append({
                "B": B, "S": S, "N": N, "kernel_ms": time_ms(call),
                "kernel_ms_back_to_back": time_ms_back_to_back(call),
                "plain_ms": time_ms(
                    lambda: tb.trajectory_core_backward_reference(
                        *args, dout, scale, heads), warmup=1, iters=3),
                "bound_ms": bound_ms, "bound_by": bound_by})
        del args, dout, xs, q2
        torch.cuda.empty_cache()
    args = extreme_inputs(-1.0, 60.0, gen, N=441)
    dout = (torch.randn(args[0].shape, generator=gen, device=DEV)
            * 0.1).bfloat16()
    cases.append(check_core_backward(tb, args, dout, scale, heads,
                                     "extreme -60.0 N=441")[0])
    del args, dout
    per_call = {c["device_launches"] for c in cases}
    if per_call != {BWD_DEVICE_LAUNCHES_PER_CALL}:
        raise AssertionError(f"backward device launches per call {per_call}, "
                             f"expected {BWD_DEVICE_LAUNCHES_PER_CALL}")
    per_call = per_call.pop()
    emit({"phase": "kernel", "name": "trajectory_block_bwd", "ok": True,
          "tolerance": f"each of {list(GRAD_NAMES)}: max|err| <= "
                       f"{KERNEL_TOL_REL} x max|ref| and relative L2 error "
                       f"<= {BWD_REL_L2} (bf16 kernel from the forward "
                       "kernel's xs and q2 vs plain float32 on the same bf16 "
                       "inputs, TF32 off); a second call bit-equal to the "
                       "first; no float32 [B S F, C] scratch",
          "device_launches_per_call": per_call,
          "library_ms": None,
          "library_note": "no single PyTorch call computes the trajectory "
                          "core's backward",
          "timing": timing, "cases": cases})
    errs = [c[n]["max_abs_err"] for c in cases for n in GRAD_NAMES]
    hr = {t["N"]: t for t in timing if t["B"] == HR_BATCH}
    return {"name": "trajectory_block_bwd", "route": "cuda",
            "source": "focus_tpu_torch/csrc/trajectory_block_bwd.cu",
            "replaces": "focus_tpu/ops/pallas/trajectory_block.py:1198",
            "max_abs_err": max(errs), "ms": timing[0]["kernel_ms"],
            "plain_ms": timing[0]["plain_ms"],
            "bound_ms": timing[0]["bound_ms"],
            "bound_by": timing[0]["bound_by"], "library_ms": None,
            "device_launches_per_call": per_call,
            "shape": "B=8 S=1568 N=196 F=8 C=768 heads=12 "
                     f"(S=1600: {timing[1]['kernel_ms']:.4f} ms)",
            "hr336": {
                "ms": hr[441]["kernel_ms"],
                "ms_back_to_back": hr[441]["kernel_ms_back_to_back"],
                "plain_ms": hr[441]["plain_ms"],
                "bound_ms": hr[441]["bound_ms"],
                "bound_by": hr[441]["bound_by"],
                "ms_n445": hr[445]["kernel_ms"],
                "ms_back_to_back_n445": hr[445]["kernel_ms_back_to_back"],
                "plain_ms_n445": hr[445]["plain_ms"],
                "bound_ms_n445": hr[445]["bound_ms"],
                "shape": "B=4 S=3528 N=441 (and S=3560 N=445) F=8 C=768 "
                         "heads=12: the dq kernel's chunked form"}}


def space_stage_bytes_flops(BH, S, F, N, d):
    """The space stage's least work: q, k and v read once (bf16), the
    [BH, S, F, d] output written once, and the QK^T and PV products."""
    return 2 * (3 * BH * S * d + BH * S * F * d), 2 * 2 * BH * S * F * N * d


def sdpa_times(q, kf, vf, F, scale, ref, tag):
    """One PyTorch call for the space stage's function: SDPA with q
    broadcast over the frames, giving [BH, F, S, d] (checked against
    ``ref``); the transpose to [BH, S, F, d] the port writes directly is
    timed apart."""
    BH, S, d = q.shape
    qx = q.unsqueeze(1).expand(BH, F, S, d)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qx, kf, vf, scale=scale)
    check_close(f"SDPA {tag}", lib.transpose(1, 2), ref)
    return {"library_ms": time_ms(lambda: sdpa(qx, kf, vf, scale=scale)),
            "library_ms_back_to_back": time_ms_back_to_back(
                lambda: sdpa(qx, kf, vf, scale=scale)),
            "library_transpose_ms": time_ms(
                lambda: lib.transpose(1, 2).contiguous())}


def space_stage_case(ta, attn_ops, q, k, v, F, scale, tag):
    """Kernel 8 on q, k, v [BH, S, d] against its plain version in float32
    (KERNEL_TOL_REL), a second call bit-equal to the first, and (past 256
    keys a frame) the device kernels of one call: the chunked form alone.
    Returns (case, out, ref)."""
    out = ta.space_stage(q, k, v, F, scale)
    again = ta.space_stage(q, k, v, F, scale)
    ref = attn_ops.space_stage(q.float(), k.float(), v.float(), F, scale)
    torch.cuda.synchronize()
    err, ref_max = check_close(f"space_stage {tag}", out, ref)
    if not torch.equal(out, again):
        raise AssertionError(f"space_stage {tag}: two calls differ")
    BH, S, d = q.shape
    case = {"case": tag, "BH": BH, "S": S, "F": F, "N": S // F, "d": d,
            "max_abs_err": err, "max_abs_ref": ref_max,
            "two_calls_bitwise_equal": True}
    if S // F > 256:
        names = device_kernels(lambda: ta.space_stage(q, k, v, F, scale))
        if len(names) != 1 or "space_stage_chunked_kernel" not in names[0]:
            raise AssertionError(f"space_stage {tag}: device kernels "
                                 f"{names}, expected the chunked form alone")
        case["device_kernels"] = names
    return case, out, ref


def phase_space_stage():
    """Kernel 8 (the learned-v path's stage 1) against its plain version
    at the learned-v slice's shapes (BH = 96, F = 8, N = 196 and 200), with
    its kernel, plain and SDPA times; past 256 keys a frame (its chunked
    form) at the HR learned-v shape, BH = 48 with N = 441 and 445 (kernel
    times and bound_ms at both, plain and SDPA at 441), BH = 24 with N =
    257 and 512, and an extreme input at N = 441, each within the gate,
    two calls bit-equal and one device kernel a call; and the autograd
    Function's backward (the plain float32 backward) at B = 2 (N = 196 and
    441) against autograd of the float32 plain forward."""
    from focus_tpu_torch.ops import attention as attn_ops
    from focus_tpu_torch.ops import trajectory_attention as ta

    gen = torch.Generator(device=DEV)
    gen.manual_seed(7)
    BH, F, d, scale = 96, 8, 64, 64 ** -0.5
    cases, timing = [], None
    for N in (196, 200):
        S = F * N
        q, k, v = ((torch.randn(BH, S, d, generator=gen, device=DEV))
                   .bfloat16() for _ in range(3))
        case, out, ref = space_stage_case(ta, attn_ops, q, k, v, F, scale,
                                          f"N={N}")
        case["kernel_ms"] = time_ms(lambda: ta.space_stage(q, k, v, F, scale))
        case["kernel_ms_back_to_back"] = time_ms_back_to_back(
            lambda: ta.space_stage(q, k, v, F, scale))
        case["plain_ms"] = time_ms(
            lambda: attn_ops.space_stage(q, k, v, F, scale), warmup=1,
            iters=5)
        case.update(sdpa_times(q, k.reshape(BH, F, N, d),
                               v.reshape(BH, F, N, d), F, scale, ref,
                               f"N={N}"))
        nbytes_, flops = space_stage_bytes_flops(BH, S, F, N, d)
        case["bound_ms"], case["bound_by"] = bound(flops, nbytes_)
        case["plan"] = ta.space_stage_plan(BH, S, F, N)
        cases.append(case)
        if N == 196:
            timing = case
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    # past 256 keys a frame, the chunked form: the HR learned-v shape
    # (batch 4, BH = 48) at N = 441 and 445, timed; the narrowest and
    # widest chunked N at BH = 24; an extreme input at N = 441
    hr = {}
    for BH_, N in ((4 * 12, 441), (4 * 12, 445), (2 * 12, 257),
                   (2 * 12, 512)):
        S = F * N
        q, k, v = ((torch.randn(BH_, S, d, generator=gen, device=DEV))
                   .bfloat16() for _ in range(3))
        case, out, ref = space_stage_case(ta, attn_ops, q, k, v, F, scale,
                                          f"BH={BH_} N={N}")
        if BH_ == 4 * 12:
            def call():
                ta.space_stage(q, k, v, F, scale)

            case["kernel_ms"] = time_ms(call)
            case["kernel_ms_back_to_back"] = time_ms_back_to_back(call)
            nbytes_, flops = space_stage_bytes_flops(BH_, S, F, N, d)
            case["bound_ms"], case["bound_by"] = bound(flops, nbytes_)
            case["plan"] = ta.space_stage_plan(BH_, S, F, N)
            if N == 441:
                case["plain_ms"] = time_ms(
                    lambda: attn_ops.space_stage(q, k, v, F, scale),
                    warmup=1, iters=5)
                case.update(sdpa_times(q, k.reshape(BH_, F, N, d),
                                       v.reshape(BH_, F, N, d), F, scale,
                                       ref, f"BH={BH_} N={N}"))
            hr[N] = case
        cases.append(case)
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    for sign, mag in ((-1.0, 60.0), (1.0, 50.0)):
        q, kf, vf = extreme_inputs(sign, mag, gen, B=12, N=441, C=64,
                                   heads=1)[:3]
        cases.append(space_stage_case(
            ta, attn_ops, q, kf.reshape(12, F * 441, d),
            vf.reshape(12, F * 441, d), F, scale,
            f"extreme {sign * mag} N=441")[0])
        del q, kf, vf
    # the backward of the autograd Function at B = 2 (BH = 24), at N = 196
    # and (the chunked forward) 441
    bwd = {}
    for N in (196, 441):
        S = F * N
        leaves = [(torch.randn(24, S, d, generator=gen, device=DEV))
                  .bfloat16().requires_grad_(True) for _ in range(3)]
        g = (torch.randn(24, S, F, d, generator=gen, device=DEV)
             * 0.1).bfloat16()
        before = ta.LAUNCHES
        ta.space_stage(*leaves, F, scale).backward(g)
        launched = ta.LAUNCHES - before
        ref_leaves = [t.detach().float().requires_grad_(True) for t in leaves]
        attn_ops.space_stage(*ref_leaves, F, scale).backward(g.float())
        torch.cuda.synchronize()
        bwd[f"N={N}"] = {
            "BH": 24, "S": S, "N": N,
            **{name: grad_errors(f"space_stage backward N={N} {name}",
                                 t.grad, r.grad)
               for name, t, r in zip(("dq", "dk", "dv"), leaves, ref_leaves)}}
        if launched != 1:
            raise AssertionError(f"space_stage backward N={N}: {launched} "
                                 "forward launches, expected 1")
        del leaves, g, ref_leaves
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "name": "space_stage", "ok": True,
          "tolerance": f"max|err| <= {KERNEL_TOL_REL} x max|ref| (bf16 "
                       "weights and output vs plain float32 on the same "
                       "inputs; past 256 keys a frame the chunked form, "
                       "whose weights are rounded unnormalised, ROADMAP.md "
                       "section 3); two calls bit-equal; past 256 one "
                       "device kernel a call, the chunked form; backward: "
                       "each gradient max|err| <= "
                       f"{KERNEL_TOL_REL} x max|ref| and relative L2 <= "
                       f"{BWD_REL_L2} against autograd of the float32 plain "
                       "forward",
          "library_call": "F.scaled_dot_product_attention, q expanded over "
                          "the frames to [BH, F, S, d], kf / vf [BH, F, N, "
                          "d]; its transpose to [BH, S, F, d] timed apart",
          "timing": "kernel_ms / library_ms: median of per-call CUDA-event "
                    "times, each call from an idle card (the host's launch "
                    "work included); *_back_to_back: 20 calls issued back "
                    "to back between two events, the mean",
          "cases": cases, "backward": bwd})
    return {"name": "space_stage", "route": "cuda",
            "source": "focus_tpu_torch/csrc/trajectory_attention.cu",
            "replaces": "focus_tpu/ops/pallas/trajectory_attention.py:35",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": timing["kernel_ms_back_to_back"],
            "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            "library_ms": timing["library_ms_back_to_back"],
            "ms_per_call": timing["kernel_ms"],
            "library_ms_per_call": timing["library_ms"],
            "ms_note": "ms and library_ms: 20 calls back to back between "
                       "two events; *_per_call: the median of calls each "
                       "from an idle card, the host's launch work included",
            "shape": "BH=96 S=1568 F=8 N=196 d=64 (N=200: "
                     f"{cases[1]['kernel_ms_back_to_back']:.4f} ms)",
            "hr336": {
                "ms": hr[441]["kernel_ms_back_to_back"],
                "ms_per_call": hr[441]["kernel_ms"],
                "plain_ms": hr[441]["plain_ms"],
                "bound_ms": hr[441]["bound_ms"],
                "bound_by": hr[441]["bound_by"],
                "library_ms": hr[441]["library_ms_back_to_back"],
                "library_ms_per_call": hr[441]["library_ms"],
                "library_transpose_ms": hr[441]["library_transpose_ms"],
                "ms_n445": hr[445]["kernel_ms_back_to_back"],
                "ms_per_call_n445": hr[445]["kernel_ms"],
                "bound_ms_n445": hr[445]["bound_ms"],
                "shape": "BH=48 S=3528 N=441 (and S=3560 N=445) F=8 d=64: "
                         "the learned-v stack at the 336 crop, batch 4; the "
                         "chunked form"}}


VARIANT_SOURCES = {3: ("focus_tpu_torch/csrc/trajectory_block.cu",
                       "focus_tpu/ops/pallas/trajectory_block.py:57"),
                   7: ("focus_tpu_torch/csrc/trajectory_block.cu",
                       "focus_tpu/ops/pallas/trajectory_block.py:545"),
                   5: ("focus_tpu_torch/csrc/trajectory_block_v5.cu",
                       "focus_tpu/ops/pallas/trajectory_block.py:872"),
                   6: ("focus_tpu_torch/csrc/trajectory_block_v6.cu",
                       "focus_tpu/ops/pallas/trajectory_block.py:711")}


def variant_counts(tb):
    return {"v4": tb.LAUNCHES, "v3": tb.V3_LAUNCHES,
            "v3_device": tb.V3_DEVICE_LAUNCHES, "v7": tb.V7_LAUNCHES,
            "v7_device": tb.V7_DEVICE_LAUNCHES, "v5": tb.V5_LAUNCHES,
            "v5_device": tb.V5_DEVICE_LAUNCHES, "v6": tb.V6_LAUNCHES,
            "v6_device": tb.V6_DEVICE_LAUNCHES, "bwd": tb.BWD_LAUNCHES}


def run_version(tb, version, fn):
    """``fn()`` under FWD_VERSION = ``version``, restored to 4 after."""
    tb.FWD_VERSION = version
    try:
        return fn()
    finally:
        tb.FWD_VERSION = 4


VERSIONS = (3, 7, 5, 6)  # the forward versions beside kernel 1 (version 4)
SAME_FUNCTION = (3, 7)  # the versions that compute kernel 1's function
# kernels 3 and 4 are kernel 1's three launches in the rounding mode V3
SAME_FUNCTION_DEVICE_LAUNCHES = 3
# kernels 5 and 6: the k2v GEMM, the own-frame aggregates, the q2 GEMM and
# the pass (csrc/trajectory_k2v.cuh)
K2V_DEVICE_LAUNCHES = 4


def check_variant_device_kernels(tb, version, args, scale, heads, tag):
    """Past 256 keys a frame, the device kernels one call of version
    ``version``'s wrapper launches, as torch.profiler traces them: v3 and
    v7 the chunked stage 1, the GEMM and the V3 stage 2; v5 and v6 the k2v
    GEMM, the own-frame launch and the q2 GEMM and the pass, both of them
    in their chunked form (template argument CH = 2)."""
    if version in SAME_FUNCTION:
        launch = {3: tb._launch_v3, 7: tb._launch_v7}[version]
        names = device_kernels(lambda: launch(*args[:6], scale, heads))
        expect = [r"space_stage_chunked_kernel<", r"traj_gemm_kernel",
                  r"traj_stage2_kernel<"]
    else:
        names = device_kernels(lambda: tb._launch_variant(
            version, *args[:6], scale, heads))
        expect = [r"traj_gemm_kernel", r"own_frame_kernel<\d+, 2>",
                  r"traj_gemm_kernel", r"k2v_pass_kernel<\d+, [^,]+, 2>"]
    if len(names) != len(expect) or not all(
            re.search(e, n) for e, n in zip(expect, names)):
        raise AssertionError(f"v{version} {tag}: device kernels {names}, "
                             f"expected {expect}")
    return names


def check_k2v_outputs(tb, args, scale, heads, tag):
    """Kernels 5 and 6 on the same inputs, each called twice: the two calls
    bit-equal (out, q2 and v5's x_diag; v6's xs); v6's xs on each row's own
    frame bit-equal to v5's x_diag (both come from the own-frame launch and
    the pass with one softmax and one product order, so the q2 that kernel
    7 reads belongs to the xs it reads), and the two versions' q2 bit-equal
    (one GEMM on those rows)."""
    from focus_tpu_torch.ops import attention as attn_ops

    runs = {v: [tb._launch_variant(v, *args[:6], scale, heads)
                for _ in range(2)] for v in (5, 6)}
    torch.cuda.synchronize()
    report = {}
    for v, (a, b) in runs.items():
        pairs = [("out", a[0], b[0]), ("q2", a[2], b[2])]
        pairs += ([("xs", a[1], b[1])] if v == 6
                  else [("x_diag", a[3]["x_diag"], b[3]["x_diag"])])
        same = {name: torch.equal(x, y) for name, x, y in pairs}
        if not all(same.values()):
            raise AssertionError(f"v{v} {tag}: two calls differ {same}")
        report[f"v{v}_two_calls_bitwise_equal"] = same
    x_diag = runs[5][0][3]["x_diag"]
    own = attn_ops.take_diagonal(runs[6][0][1], args[1].shape[1])
    gap = (own.float() - x_diag.float()).abs().max().item()
    report["v6_xs_own_frame_vs_x_diag_max_abs_diff"] = gap
    report["v6_q2_bitwise_equal_to_v5"] = torch.equal(runs[6][0][2],
                                                      runs[5][0][2])
    if gap != 0 or not report["v6_q2_bitwise_equal_to_v5"]:
        raise AssertionError(f"{tag}: v6's own-frame xs or q2 is not the "
                             f"own-frame launch's ({report})")
    return report


def phase_variants():
    """The forward versions 3, 7, 5 and 6 of the trajectory core against
    their step-by-step plain versions (the gate) and against the plain
    trajectory core (gated for v3 and v7, which compute its function;
    reported for v5 and v6: their k2v identity holds only where every
    head's stage-1 weights agree), at B = 8 and N = 196 and 200, at the
    HR-336 shapes past 256 keys a frame (B = 4 with N = 441 and 445, B = 2
    with N = 257 and 512; their chunked forms, whose device kernels are
    checked by name), and on the two extreme inputs at N = 196 and at N =
    441 (gated for all); for v3 and v7 also the xs and q2
    they write against the plain stage 1 in their rounding, and two calls
    bit-equal; for v5 and v6 two calls bit-equal and v6's own-frame xs
    bit-equal to the x_diag both form (``check_k2v_outputs``), all of it
    also at B = 2 with N = 256, 65, and 24 at F = 4, and at one frame; the
    device launches a call (3 for v3 and v7, 4 for v5 and v6); kernel,
    plain and version-4 times on the same inputs at B = 8 and at B = 4
    with N = 441 and 445 (each call from an idle card, and 20 back to
    back; and kernel 3's beside v7);
    one backward per version at B = 2 through _FusedCore against the
    version-4 gradients."""
    from focus_tpu_torch.ops import trajectory_block as tb

    heads, scale, C = 12, 64 ** -0.5, 768
    plain = {3: tb.trajectory_core_v3_reference,
             7: tb.trajectory_core_v7_reference,
             5: tb.trajectory_core_v5_reference,
             6: tb.trajectory_core_v6_reference}
    counted = ("v4",) + tuple(f"v{v}" for v in VERSIONS)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(8)
    results = {v: {"cases": [], "timing": []} for v in VERSIONS}
    # (tag, inputs, timed)
    inputs = [(f"B=8 N={N}", core_inputs(8, N, gen), True)
              for N in (196, 200)]
    inputs += [(f"extreme {sign * mag}", extreme_inputs(sign, mag, gen),
                False) for sign, mag in ((-1.0, 60.0), (1.0, 50.0))]
    inputs += [(f"B={B} N={N}", core_inputs(B, N, gen), B == HR_BATCH)
               for B, N in HR_KERNEL_CASES]
    inputs += [(f"extreme {sign * mag} N=441",
                extreme_inputs(sign, mag, gen, N=441), False)
               for sign, mag in ((-1.0, 60.0), (1.0, 50.0))]
    for tag, args, timed in inputs:
        true = tb.trajectory_core_reference(*[a.float() for a in args],
                                            scale, heads)
        extreme = tag.startswith("extreme")
        chunked = args[1].shape[2] > tb.MAX_KEYS
        for v in VERSIONS:
            before = variant_counts(tb)
            out = run_version(tb, v, lambda: tb.fused_trajectory_core(
                *args, scale, heads))
            after = variant_counts(tb)
            own = plain[v](*args, scale, heads)
            torch.cuda.synchronize()
            err, ref_max = check_close(f"v{v} {tag} vs its plain version",
                                       out, own)
            true_err = (out.float() - true).abs().max().item()
            case = {"case": tag, "max_abs_err": err, "max_abs_ref": ref_max,
                    "vs_trajectory_core_max_abs_err": true_err,
                    "trajectory_core_max_abs": true.abs().max().item(),
                    "device_launches": after[f"v{v}_device"]
                    - before[f"v{v}_device"],
                    "wrapper_launches": {k: after[k] - before[k]
                                         for k in counted}}
            if case["wrapper_launches"] != {k: int(k == f"v{v}")
                                            for k in counted}:
                raise AssertionError(f"v{v} {tag}: launches "
                                     f"{case['wrapper_launches']}")
            if extreme or v in SAME_FUNCTION:
                check_close(f"v{v} {tag} vs the trajectory core", out, true)
            if v in SAME_FUNCTION:
                case.update(check_v3_stage1_outputs(tb, v, args, scale,
                                                    heads, tag))
            elif v == 6:  # both k2v kernels' outputs, once per input
                case.update(check_k2v_outputs(tb, args, scale, heads, tag))
            if chunked:
                case["device_kernels"] = check_variant_device_kernels(
                    tb, v, args, scale, heads, tag)
            results[v]["cases"].append(case)
            if timed:
                B, S, C_ = args[0].shape
                N = args[1].shape[2]
                t = {"case": tag,
                     "kernel_ms": run_version(tb, v, lambda: time_ms(
                         lambda: tb.fused_trajectory_core(*args, scale,
                                                          heads))),
                     "kernel_ms_back_to_back": run_version(
                         tb, v, lambda: time_ms_back_to_back(
                             lambda: tb.fused_trajectory_core(*args, scale,
                                                              heads))),
                     "v4_kernel_ms_same_inputs": time_ms(
                         lambda: tb.fused_trajectory_core(*args, scale,
                                                          heads)),
                     "v4_kernel_ms_back_to_back_same_inputs":
                         time_ms_back_to_back(
                             lambda: tb.fused_trajectory_core(*args, scale,
                                                              heads)),
                     "plain_ms": time_ms(lambda: plain[v](*args, scale,
                                                          heads),
                                         warmup=1, iters=3)}
                if v == 7:
                    t["v3_kernel_ms_same_inputs"] = run_version(
                        tb, 3, lambda: time_ms(
                            lambda: tb.fused_trajectory_core(*args, scale,
                                                             heads)))
                t["bound_ms"], t["bound_by"] = bound(
                    core_flops(B, S, 8, N, C_), nbytes(*args) + nbytes(out))
                if v in (5, 6):  # the k2v form's work; v6 also writes xs
                    t["bound_ms_kernel_1_function"] = t["bound_ms"]
                    t["bound_ms"], t["bound_by"] = bound(
                        k2v_flops(B, S, 8, N, C_),
                        nbytes(*args[:6]) + nbytes(out) * (9 if v == 6 else 1))
                    t["design_gflop"] = (k2v_flops(B, S, 8, N, C_)
                                         + own_frame_flops(B, S, N, C_)) / 1e9
                results[v]["timing"].append(t)
            del out, own
        del true
        torch.cuda.empty_cache()

    # one backward per version at B = 2, against version 4's gradients
    args = core_inputs(2, 196, gen)
    dout = (torch.randn(args[0].shape, generator=gen, device=DEV)
            * 0.1).bfloat16()

    def grads(version):
        leaves = [a.clone().requires_grad_(True) for a in args]
        before = variant_counts(tb)
        out = run_version(tb, version, lambda: tb.fused_trajectory_core(
            *leaves, scale, heads))
        out.backward(dout)
        torch.cuda.synchronize()
        after = variant_counts(tb)
        return ([t.grad for t in leaves[:6]],
                {k: after[k] - before[k] for k in counted + ("bwd",)})

    ref, _ = grads(4)
    for v in VERSIONS:
        got, counts = grads(v)
        # v5 forms no xs: its backward recomputes xs and q2 with kernel 1
        expect = {k: int(k == f"v{v}" or (k == "v4" and v == 5))
                  for k in counted}
        expect["bwd"] = 1
        if counts != expect:
            raise AssertionError(f"v{v} backward: launches {counts}, "
                                 f"expected {expect}")
        results[v]["backward"] = {
            "launches": counts,
            "bitwise_equal_to_v4": all(torch.equal(a, b)
                                       for a, b in zip(got, ref)),
            **{n: grad_errors(f"v{v} backward {n}", a, b)
               for n, a, b in zip(GRAD_NAMES, got, ref)}}

    # the other forms of kernels 5 and 6: keys padded to 256 (one Q tile
    # and one staging tile), to 128 and, at F = 4, to 64 (own-frame units
    # that span several frames), and one frame
    for B, N, F in ((2, 256, 8), (2, 65, 8), (2, 24, 4), (1, 196, 1)):
        args = core_inputs(B, N, gen, F=F)
        tag = f"B={B} N={N} F={F}"
        for v in (5, 6):
            before = variant_counts(tb)
            out = run_version(tb, v, lambda: tb.fused_trajectory_core(
                *args, scale, heads))
            after = variant_counts(tb)
            own = plain[v](*args, scale, heads)
            torch.cuda.synchronize()
            err, ref_max = check_close(f"v{v} {tag} vs its plain version",
                                       out, own)
            results[v]["cases"].append(
                {"case": tag, "max_abs_err": err, "max_abs_ref": ref_max,
                 "device_launches": after[f"v{v}_device"]
                 - before[f"v{v}_device"]})
            del out, own
        results[6]["cases"][-1].update(
            check_k2v_outputs(tb, args, scale, heads, tag))
    rows = []
    for v in VERSIONS:
        r = results[v]
        per_call = {c["device_launches"] for c in r["cases"]}
        expect = (SAME_FUNCTION_DEVICE_LAUNCHES if v in SAME_FUNCTION
                  else K2V_DEVICE_LAUNCHES)
        if per_call != {expect}:
            raise AssertionError(f"v{v} device launches per call {per_call}, "
                                 f"expected {expect}")
        per_call = per_call.pop()
        against_core = (
            "and against the plain trajectory core (float32) on every input: "
            f"v{v} computes its function, rounded at other points"
            if v in SAME_FUNCTION else
            "and against the plain trajectory core on the extreme inputs; on "
            "the random inputs the distance to the trajectory core is "
            "reported, not gated: the variant computes another function "
            "there (the k2v identity needs equal stage-1 weights in every "
            "head)")
        emit({"phase": "kernel", "name": f"trajectory_block_v{v}", "ok": True,
              "tolerance": f"max|err| <= {KERNEL_TOL_REL} x max|ref| against "
                           f"trajectory_core_v{v}_reference on the same bf16 "
                           "inputs (its rounding points, float32 sums), "
                           f"{against_core}"
                           + ("; the xs and q2 it writes within the same "
                              "bound of trajectory_core_v3_stage1_reference "
                              "on the same bf16 inputs, xs's mean|err| / "
                              f"mean|ref| within {V3_XS_MEAN_REL} where "
                              "kernel 1's xs must read above it, and two "
                              "calls bit-equal (out, xs, q2)"
                              if v in SAME_FUNCTION else
                              "; two calls bit-equal (out, q2, v5's x_diag, "
                              "v6's xs), v6's own-frame xs bit-equal to "
                              "x_diag and v6's q2 to v5's")
                           + "; backward: each gradient within "
                           f"{KERNEL_TOL_REL} x max|ref| and {BWD_REL_L2} "
                           "relative L2 of version 4's",
              "device_launches_per_call": per_call,
              "library_ms": None,
              "library_note": "no single PyTorch call computes trajectory "
                              "attention",
              **r})
        t = r["timing"][0]
        hr = {x["case"]: x for x in r["timing"]}
        hr441, hr445 = hr[f"B={HR_BATCH} N=441"], hr[f"B={HR_BATCH} N=445"]
        row = {
            "name": f"trajectory_block_v{v}", "route": "cuda",
            "source": VARIANT_SOURCES[v][0], "replaces": VARIANT_SOURCES[v][1],
            "max_abs_err": max(c["max_abs_err"] for c in r["cases"]),
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "device_launches_per_call": per_call,
            "ms_back_to_back": t["kernel_ms_back_to_back"],
            "v4_ms_same_inputs": t["v4_kernel_ms_same_inputs"],
            "v4_ms_back_to_back_same_inputs":
                t["v4_kernel_ms_back_to_back_same_inputs"],
            "ms_note": "ms: the median of calls each from an idle card (the "
                       "host's launch work included); ms_back_to_back: 20 "
                       "calls issued back to back between two events, the "
                       "mean",
            "shape": "B=8 S=1568 N=196 F=8 C=768 heads=12 "
                     f"(S=1600: {r['timing'][1]['kernel_ms']:.4f} ms)",
            "hr336": {
                "ms": hr441["kernel_ms"],
                "ms_back_to_back": hr441["kernel_ms_back_to_back"],
                "plain_ms": hr441["plain_ms"],
                "bound_ms": hr441["bound_ms"],
                "bound_by": hr441["bound_by"],
                "v4_ms_same_inputs": hr441["v4_kernel_ms_same_inputs"],
                "v4_ms_back_to_back_same_inputs":
                    hr441["v4_kernel_ms_back_to_back_same_inputs"],
                "ms_n445": hr445["kernel_ms"],
                "ms_back_to_back_n445": hr445["kernel_ms_back_to_back"],
                "plain_ms_n445": hr445["plain_ms"],
                "bound_ms_n445": hr445["bound_ms"],
                "v4_ms_same_inputs_n445": hr445["v4_kernel_ms_same_inputs"],
                "shape": f"B={HR_BATCH} S=3528 N=441 (and S=3560 N=445) F=8 "
                         "C=768 heads=12: the chunked form"}}
        if v == 7:
            row["v3_ms_same_inputs"] = t["v3_kernel_ms_same_inputs"]
        if v in (5, 6):
            row["bound_ms_kernel_1_function"] = t["bound_ms_kernel_1_function"]
            row["design_gflop"] = t["design_gflop"]
            row["bound_note"] = (
                "bound_ms: the function's work in its k2v form (k2v_flops: "
                "the k2v and q2 GEMMs, QK, PV and P . k2v over all keys, the "
                "stage-2 row dots and the mix) at the bf16 peak; "
                "bound_ms_kernel_1_function: kernel 1's function "
                "(core_flops); design_gflop: what the four launches do, the "
                "own-frame launch's own_frame_flops included")
        rows.append(row)
    return rows


def time_in_turns(fns, warmup=3, iters=TIMED_ITERS):
    """Median per-call CUDA-event time (ms) of each callable, the callables
    called in turns (one call of each a round) after ``warmup`` calls of
    each: a comparison that the card's clocks and its neighbours move
    alike."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(iters):
        for i, fn in enumerate(fns):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


def patch_case(pe, shape, kernel, D, gen, dtype):
    """Kernel 2 on a random video of ``shape`` at ``dtype`` against the
    plain version in float32 (same bf16-rounded video, weight and bias),
    and a second call bit-equal to the first."""
    x = torch.rand(*shape, generator=gen, device=DEV).to(dtype)
    w = (torch.randn(*kernel, shape[-1], D, generator=gen, device=DEV)
         * 0.02).bfloat16()
    b = (torch.randn(D, generator=gen, device=DEV) * 0.02).bfloat16()
    out, thw = pe.patch_embed_3d(x, w, b, kernel, torch.bfloat16)
    again, _ = pe.patch_embed_3d(x, w, b, kernel, torch.bfloat16)
    ref = pe.patch_embed_reference(x.bfloat16().float(), w.float(), b.float(),
                                   kernel)
    torch.cuda.synchronize()
    B, T, H, W, _ = shape
    tp, hp, wp = T // kernel[0], H // kernel[1], W // kernel[2]
    if tuple(out.shape) != (B, tp * hp * wp, D) or thw != (tp, hp, wp):
        raise AssertionError(f"patch_embed {shape}: shape {tuple(out.shape)}")
    tag = f"patch_embed {list(shape)} {str(dtype)[6:]} D={D}"
    err, ref_max = check_close(tag, out, ref)
    if not torch.equal(out, again):
        raise AssertionError(f"{tag}: two calls differ")
    return {"video": list(shape), "dtype": str(dtype)[6:], "kernel": kernel,
            "D": D, "max_abs_err": err, "max_abs_ref": ref_max,
            "two_calls_bitwise_equal": True,
            "plan": pe.patch_embed_plan(shape, kernel, D, dtype)}


def phase_patch_kernel():
    """Kernel 2 against its plain version on the flagship's video (bf16 and
    the float32 video the model hands it), the 336 crop, T = 15 (the last
    frame outside every tubelet) and other C and D, each call twice
    bit-equal; its time on the float32 video; and, in turns on the same
    bf16 video, the kernel and F.conv3d on a contiguous NCTHW copy and on
    the channels_last_3d view (no copy), the faster of the two being
    ``library_ms``."""
    from focus_tpu_torch.ops import patch_embed as pe

    gen = torch.Generator(device=DEV)
    gen.manual_seed(1)
    kernel, D = (2, 16, 16), 768
    cases = [patch_case(pe, shape, k, d, gen, dtype) for shape, k, d, dtype in (
        ((8, 16, 224, 224, 3), kernel, D, torch.bfloat16),
        ((8, 16, 224, 224, 3), kernel, D, torch.float32),
        ((4, 16, 336, 336, 3), kernel, D, torch.float32),
        ((8, 15, 224, 224, 3), kernel, D, torch.float32),
        ((2, 4, 64, 64, 8), kernel, 384, torch.bfloat16),
        ((2, 5, 40, 40, 3), (2, 8, 8), 100, torch.bfloat16),
        ((1, 4, 37, 45, 1), (1, 4, 5), 36, torch.float32),
        ((1, 2, 15, 15, 3), (1, 3, 3), 64, torch.bfloat16))]
    x32 = torch.rand(8, 16, 224, 224, 3, generator=gen, device=DEV)
    x16 = x32.bfloat16()
    w = (torch.randn(2, 16, 16, 3, D, generator=gen, device=DEV) * 0.02).bfloat16()
    b = (torch.randn(D, generator=gen, device=DEV) * 0.02).bfloat16()
    kernel_ms = time_ms(lambda: pe.patch_embed_3d(x32, w, b, kernel, torch.bfloat16))
    kernel_b2b_ms = time_ms_back_to_back(
        lambda: pe.patch_embed_3d(x32, w, b, kernel, torch.bfloat16))
    plain_ms = time_ms(lambda: pe.patch_embed_reference(x32, w, b, kernel,
                                                         torch.bfloat16))
    conv = torch.nn.functional.conv3d
    w_conv = w.permute(4, 3, 0, 1, 2).contiguous()
    w_conv_cl = w_conv.contiguous(memory_format=torch.channels_last_3d)
    x_ncthw = x16.permute(0, 4, 1, 2, 3).contiguous()
    x_cl = x16.permute(0, 4, 1, 2, 3)  # channels_last_3d strides, no copy
    ref16 = pe.patch_embed_reference(x16.float(), w.float(), b.float(), kernel)
    for name, lib in (("ncthw_copy", conv(x_ncthw, w_conv, b, stride=kernel)),
                      ("channels_last_view",
                       conv(x_cl, w_conv_cl, b, stride=kernel))):
        check_close(f"F.conv3d {name}", lib.flatten(2).transpose(1, 2), ref16)
    k16_ms, ncthw_ms, cl_ms = time_in_turns([
        lambda: pe.patch_embed_3d(x16, w, b, kernel, torch.bfloat16),
        lambda: conv(x_ncthw, w_conv, b, stride=kernel),
        lambda: conv(x_cl, w_conv_cl, b, stride=kernel)])
    library_ms = min(ncthw_ms, cl_ms)
    library_form = ("contiguous NCTHW copy" if ncthw_ms <= cl_ms
                    else "channels_last_3d view")
    M, K = 8 * 1568, 2 * 16 * 16 * 3
    bound_ms, bound_by = bound(2 * M * K * D,
                               nbytes(x32, w, b) + M * D * 2)
    bound16_ms, _ = bound(2 * M * K * D, nbytes(x16, w, b) + M * D * 2)
    emit({"phase": "kernel", "name": "patch_embed", "ok": True,
          "tolerance": f"max|err| <= {KERNEL_TOL_REL} x max|ref| (bf16 output "
                       "vs plain float32 on the same bf16-rounded inputs); "
                       "two calls bit-equal",
          "cases": cases,
          "kernel_ms": kernel_ms, "kernel_ms_back_to_back": kernel_b2b_ms,
          "plain_ms": plain_ms,
          "in_turns": {"kernel_bf16_ms": k16_ms,
                       "conv3d_ncthw_copy_ms": ncthw_ms,
                       "conv3d_channels_last_view_ms": cl_ms,
                       "bound_bf16_ms": bound16_ms,
                       "timing": f"{TIMED_ITERS} rounds of one call each, "
                                 "the medians"},
          "library_ms": library_ms, "library_form": library_form,
          "library_call": "F.conv3d on the same bf16 video, bias included; "
                          "the faster of the contiguous NCTHW copy (made "
                          "beforehand) and the channels_last_3d view",
          "bound_ms": bound_ms, "bound_by": bound_by})
    return {"name": "patch_embed", "route": "cuda",
            "source": "focus_tpu_torch/csrc/patch_embed.cu",
            "replaces": "focus_tpu/ops/pallas/patch_embed.py:33",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "ms_bf16_in_turns": k16_ms, "bound_ms_bf16": bound16_ms,
            "ms_back_to_back": kernel_b2b_ms,
            "library_note": f"F.conv3d ({library_form}) in turns with the "
                            "kernel on the same bf16 video; ms is the kernel "
                            "on the float32 video the model hands it",
            "shape": "video [8,16,224,224,3] f32 -> [8,1568,768] bf16"}


def narrow_steve_model(**decoder):
    """The port's STEVE on the card with SLOTS.DECODER overridden (the
    kernel phase's other decoder shape; the slice itself comes from
    ``steve_entry``)."""
    from focus_tpu_torch.entry import steve_cfg
    from focus_tpu_torch.models.build import build_model

    cfg = steve_cfg()
    for key, value in decoder.items():
        setattr(cfg.SLOTS.DECODER, key, value)
    return build_model(cfg, device=DEV, seed=0)


@torch.no_grad()
def ar_state(model, packed, rows, gen):
    """One decode step's inputs at a model's widths: the hoisted cross K/V of
    random slots, a dictionary row per rollout row as the token, random
    caches (every row filled, so a read or write beyond row t shows)."""
    from focus_tpu_torch.models.common import linear

    from focus_tpu_torch.ops.ar_decode import next_input

    dec, d, dt = model.steve_decoder, model.d_model, torch.bfloat16
    L = dec.pos.pe.shape[1]
    slots = torch.randn(rows, model.num_slots,
                        model.steve_encoder.slot_proj.in_features,
                        generator=gen, device=DEV).to(dt)
    slots = linear(slots, model.steve_encoder.slot_proj)
    kvs = dec.tf(slots[:, :1], slots, project_kv_only=True)
    ckv = torch.stack([torch.stack([k.reshape(rows, -1, d),
                                    v.reshape(rows, -1, d)])
                       for k, v in kvs]).contiguous()
    ids = torch.randint(0, model.vocab_size, (rows,), generator=gen,
                        device=DEV)
    caches = [torch.randn(dec.tf.num_blocks, L, rows, d, generator=gen,
                          device=DEV).to(dt) for _ in range(2)]
    return {"slots": slots, "kvs": kvs, "ckv": ckv,
            "x": next_input(packed, ids, dt).contiguous(), "k": caches[0],
            "v": caches[1], "pos": dec.pos.pe[0, :L].float().contiguous()}


def ar_counts(ar):
    """The decode-step counts: bf16 and W8A8 steps, the device kernels they
    launched and, of those, the ones launched with the PDL attribute, and
    the rollout-graph replays."""
    return {"bf16": ar.LAUNCHES, "bf16_device": ar.DEVICE_LAUNCHES,
            "bf16_pdl": ar.PDL_LAUNCHES, "w8a8": ar.W8A8_LAUNCHES,
            "w8a8_device": ar.W8A8_DEVICE_LAUNCHES,
            "w8a8_pdl": ar.W8A8_PDL_LAUNCHES,
            "graph_replays": ar.GRAPH_REPLAYS}


def reset_ar_counts(ar):
    ar.LAUNCHES = ar.DEVICE_LAUNCHES = ar.PDL_LAUNCHES = 0
    ar.W8A8_LAUNCHES = ar.W8A8_DEVICE_LAUNCHES = ar.W8A8_PDL_LAUNCHES = 0
    ar.GRAPH_REPLAYS = 0


def check_ar_step(model, packed, rows, t, gen, tag):
    """fused_ar_step against ar_step_reference from the same state (the
    bf16 or the W8A8 step, as ``packed`` is); the device kernels the one
    wrapper call launched are counted."""
    from focus_tpu_torch.ops import ar_decode as ar

    w8a8 = isinstance(packed, ar.PackedDecoderW8A8)
    tol = AR_W8A8_TOL_REL if w8a8 else AR_TOL_REL
    st = ar_state(model, packed, rows, gen)
    heads = model.steve_decoder.tf.num_heads
    outs = []
    for step in (ar.fused_ar_step, ar.ar_step_reference):
        k, v = st["k"].clone(), st["v"].clone()
        lg = torch.empty(rows, model.vocab_size, dtype=torch.float32,
                         device=DEV)
        reset_ar_counts(ar)
        nx, ids, _, _ = step(st["x"], t, packed, st["ckv"], k, v, st["pos"],
                             heads, logits_out=lg)
        torch.cuda.synchronize()
        outs.append((nx, ids.long(), k, v, lg, ar_counts(ar)))
    (nx, ids, k, v, lg, counts), (_, rids, rk, rv, rlg, stray) = outs
    mode, other = ("w8a8", "bf16") if w8a8 else ("bf16", "w8a8")
    if (any(stray.values()) or counts[mode] != 1 or counts[other]
            or counts[f"{other}_device"] or counts["graph_replays"]):
        raise AssertionError(f"{tag}: launch counts {counts}, plain "
                             f"version {stray}")
    device_launches = counts[f"{mode}_device"]
    if counts[f"{mode}_pdl"] != device_launches:
        raise AssertionError(f"{tag}: {counts[f'{mode}_pdl']} of "
                             f"{device_launches} kernels launched with PDL")
    err_lg, scale_lg = check_close(f"{tag} logits", lg, rlg, tol)
    err_k, _ = check_close(f"{tag} k row", k[:, t], rk[:, t], tol)
    err_v, _ = check_close(f"{tag} v row", v[:, t], rv[:, t], tol)
    keep = torch.ones(k.shape[1], dtype=torch.bool, device=DEV)
    keep[t] = False
    if not (torch.equal(k[:, keep], st["k"][:, keep])
            and torch.equal(v[:, keep], st["v"][:, keep])):
        raise AssertionError(f"{tag}: a cache row other than {t} changed")
    top2 = rlg.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    # logits within err of each other can change the argmax only where the
    # plain version's top-2 margin is at most 2 err
    if bool(((ids != rids) & (margin > 2 * err_lg)).any()):
        raise AssertionError(f"{tag}: ids differ beyond the logits' error")
    if not torch.equal(nx, ar.next_input(packed, ids, torch.bfloat16)):
        raise AssertionError(f"{tag}: next input is not the packed "
                             "dictionary row of the id")
    return {"case": tag, "rows": rows, "t": t, "max_abs_err_logits": err_lg,
            "max_abs_logits": scale_lg, "max_abs_err_k_row": err_k,
            "max_abs_err_v_row": err_v,
            "ids_equal": int((ids == rids).sum().item()),
            "min_top2_margin": margin.min().item(),
            "device_launches": device_launches,
            "pdl_launches": counts[f"{mode}_pdl"]}


def ar_bound(rows, D, nb, V, S, t, w8a8=False):
    """Least time of one decode step: every weight, the head and the
    gathered dictionary rows, the small float32 parameters, cache rows < t
    read and row t written, the hoisted cross K/V, the token in and out.
    W8A8: 1-byte weights plus their float32 scales, and the products as
    int8 operations."""
    n_w = nb * 14 * D * D + V * D + rows * D
    small = (nb * 11 * D + 3 * D) * 4
    cache = nb * 2 * (t + 1) * rows * D * 2
    ckv = nb * 2 * rows * S * D * 2
    io = 2 * rows * D * 2 + rows * 4
    gemm_ops = 2 * rows * (nb * 14 * D * D + V * D)
    attn_flops = nb * 4 * rows * D * (t + 1 + S)
    if w8a8:
        scales = (nb * 14 * D + V + -(-V // D) * D) * 4
        return bound(attn_flops, n_w + scales + small + cache + ckv + io,
                     int8_ops=gemm_ops)
    return bound(gemm_ops + attn_flops, n_w * 2 + small + cache + ckv + io)


@torch.no_grad()
def time_ar_step(model, packed, rows, t, gen):
    """Kernel, unfused module step and plain version at one state."""
    from focus_tpu_torch.models.common import linear
    from focus_tpu_torch.ops import ar_decode as ar

    st = ar_state(model, packed, rows, gen)
    dec, d = model.steve_decoder, model.d_model
    nb, heads = dec.tf.num_blocks, dec.tf.num_heads
    L = st["k"].shape[1]
    scratch = ar.workspace(rows, d, DEV)
    args = (st["x"], t, packed, st["ckv"], st["k"], st["v"], st["pos"], heads)
    kernel_ms = time_ms(lambda: ar.fused_ar_step(*args, scratch=scratch))
    back_to_back_ms = time_ms_back_to_back(
        lambda: ar.fused_ar_step(*args, scratch=scratch))
    reference_ms = time_ms(lambda: ar.ar_step_reference(*args), warmup=1,
                           iters=5)
    rdec = model._rollout_decoder(torch.bfloat16)
    caches = tuple(
        tuple(c[l].transpose(0, 1).reshape(rows, L, heads, d // heads)
              .contiguous() for c in (st["k"], st["v"]))
        for l in range(nb))
    x = st["x"][:, None]

    def module_step():
        out, _ = rdec.tf(rdec.pos.at(x, t), st["slots"], caches=caches, t=t,
                         cross_kvs=st["kvs"])
        z = linear(out, rdec.head).argmax(dim=-1)
        return rdec.dict(z).to(torch.bfloat16)

    module_ms = time_ms(module_step, warmup=2)
    bound_ms, bound_by = ar_bound(rows, d, nb, model.vocab_size,
                                  model.num_slots, t)
    return {"rows": rows, "t": t, "kernel_ms": kernel_ms,
            "kernel_ms_back_to_back": back_to_back_ms,
            "module_step_ms": module_ms, "reference_ms": reference_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_ar_decode(model):
    """The decode step at full width (32, 40 and 128 rows) and at the
    decoder of configs/movi_e/base.yaml (D=192, 4 blocks, 4 heads of 48)."""
    from focus_tpu_torch.ops import ar_decode as ar

    gen = torch.Generator(device=DEV)
    gen.manual_seed(2)
    dec = model.steve_decoder
    packed = model._packed_decoder(torch.bfloat16)
    cases = [check_ar_step(model, packed, 32, t, gen, f"rows=32 t={t}")
             for t in AR_STEPS]
    cases += [check_ar_step(model, packed, rows, t, gen, f"rows={rows} t={t}")
              for rows, t in ((40, 256), (40, 5), (128, 128), (128, 255))]
    timing = time_ar_step(model, packed, 32, 128, gen)
    timing128 = time_ar_step(model, packed, 128, 128, gen)
    # every full-width call must have launched the same number of device
    # kernels, the number the step is designed to launch
    per_step = {c["device_launches"] for c in cases}
    if per_step != {ar.launches_per_step(dec.tf.num_blocks)}:
        raise AssertionError(f"device launches per step {sorted(per_step)}, "
                             f"designed {ar.launches_per_step(dec.tf.num_blocks)}")
    per_step = per_step.pop()
    narrow = narrow_steve_model(DIM=192, NUM_BLOCKS=4, NUM_HEADS=4)
    npacked = narrow._packed_decoder(torch.bfloat16)
    cases += [check_ar_step(narrow, npacked, rows, t, gen,
                            f"D=192 rows={rows} t={t}")
              for rows, t in ((32, 0), (32, 200), (40, 256))]
    emit({"phase": "kernel", "name": "ar_decode", "ok": True,
          "tolerance": f"logits and cache row t: max|err| <= {AR_TOL_REL} x "
                       "max|ref| (same bf16 rounding points, float32 sums in "
                       "another order); ids equal wherever the plain "
                       "version's top-2 margin exceeds twice the logits' "
                       "error; other cache rows bit-equal; next input == "
                       "packed dictionary row",
          "device_launches_per_step": per_step,
          "device_launches_note": "counted by the C function's launch "
                                  "helper in one wrapper call; every one "
                                  "launched with the PDL attribute "
                                  "(pdl_launches, each case)",
          "library_ms": None,
          "library_note": "no single PyTorch call computes a decode step",
          "timing": [timing, timing128], "cases": cases})
    return {"name": "ar_decode", "route": "cuda",
            "source": "focus_tpu_torch/csrc/ar_decode.cu",
            "replaces": "focus_tpu/ops/pallas/ar_decode.py:53",
            "max_abs_err": max(c["max_abs_err_logits"] for c in cases),
            "ms": timing["kernel_ms"], "plain_ms": timing["module_step_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            "library_ms": None,
            "device_launches_per_step": per_step,
            "shape": "32 rows, t=128, D=2048, 8 blocks, 4 heads, V=4096, "
                     "7 slots, L=257"}


@torch.no_grad()
def time_ar_w8a8(model, packed, packed_bf16, rows, t, gen):
    """The W8A8 kernel, its plain version and (same state, same call) the
    bf16 kernel."""
    from focus_tpu_torch.ops import ar_decode as ar

    st = ar_state(model, packed, rows, gen)
    dec, d = model.steve_decoder, model.d_model
    nb, heads = dec.tf.num_blocks, dec.tf.num_heads
    args = (st["x"], t, packed, st["ckv"], st["k"], st["v"], st["pos"], heads)
    scratch = ar.workspace(rows, d, DEV, w8a8=True)
    kernel_ms = time_ms(lambda: ar.fused_ar_step(*args, scratch=scratch))
    back_to_back_ms = time_ms_back_to_back(
        lambda: ar.fused_ar_step(*args, scratch=scratch))
    plain_ms = time_ms(lambda: ar.ar_step_reference(*args), warmup=1,
                       iters=5)
    bf16_scratch = ar.workspace(rows, d, DEV)
    bf16_ms = time_ms(lambda: ar.fused_ar_step(
        st["x"], t, packed_bf16, st["ckv"], st["k"], st["v"], st["pos"],
        heads, scratch=bf16_scratch))
    bound_ms, bound_by = ar_bound(rows, d, nb, model.vocab_size,
                                  model.num_slots, t, w8a8=True)
    return {"rows": rows, "t": t, "kernel_ms": kernel_ms,
            "kernel_ms_back_to_back": back_to_back_ms,
            "reference_ms": plain_ms, "bf16_kernel_ms_same_state": bf16_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_ar_decode_w8a8(model):
    """The W8A8 decode step (the TPU kernel with int8=True) against its
    plain version at the kernel phase's states: 32 rows at AR_STEPS, 40 rows
    at t=5 and 256, 128 rows at t=128 and 255, and the D=192 decoder."""
    from focus_tpu_torch.ops import ar_decode as ar

    gen = torch.Generator(device=DEV)
    gen.manual_seed(5)
    nb = model.steve_decoder.tf.num_blocks
    packed = model._packed_decoder(torch.bfloat16, w8a8=True)
    cases = [check_ar_step(model, packed, 32, t, gen, f"w8a8 rows=32 t={t}")
             for t in AR_STEPS]
    cases += [check_ar_step(model, packed, rows, t, gen,
                            f"w8a8 rows={rows} t={t}")
              for rows, t in ((40, 5), (40, 256), (128, 128), (128, 255))]
    designed = ar.launches_per_step(nb, w8a8=True)
    per_step = {c["device_launches"] for c in cases}
    if per_step != {designed}:
        raise AssertionError(f"W8A8 device launches per step "
                             f"{sorted(per_step)}, designed {designed}")
    bf16_packed = model._packed_decoder(torch.bfloat16)
    timing = time_ar_w8a8(model, packed, bf16_packed, 32, 128, gen)
    timing128 = time_ar_w8a8(model, packed, bf16_packed, 128, 128, gen)
    narrow = narrow_steve_model(DIM=192, NUM_BLOCKS=4, NUM_HEADS=4)
    npacked = narrow._packed_decoder(torch.bfloat16, w8a8=True)
    narrow_cases = [check_ar_step(narrow, npacked, rows, t, gen,
                                  f"w8a8 D=192 rows={rows} t={t}")
                    for rows, t in ((32, 0), (32, 200), (40, 256))]
    if {c["device_launches"] for c in narrow_cases} != {
            ar.launches_per_step(4, w8a8=True)}:
        raise AssertionError("W8A8 device launches per step at D=192")
    cases += narrow_cases
    emit({"phase": "kernel", "name": "ar_decode_w8a8", "ok": True,
          "tolerance": f"logits and cache row t: max|err| <= {AR_W8A8_TOL_REL}"
                       " x max|ref| (the bf16 causes, and an activation code "
                       "that flips next to its rounding boundary moves an "
                       "output by one quantum); ids equal wherever the plain "
                       "version's top-2 margin exceeds twice the logits' "
                       "error; other cache rows bit-equal; next input == the "
                       "dequantized dictionary row of the id",
          "device_launches_per_step": designed,
          "library_ms": None,
          "library_note": "no single PyTorch call computes a decode step",
          "timing": [timing, timing128], "cases": cases})
    return {"name": "ar_decode_w8a8", "route": "cuda",
            "source": "focus_tpu_torch/csrc/ar_decode.cu",
            "replaces": "focus_tpu/ops/pallas/ar_decode.py:53 (int8=True)",
            "max_abs_err": max(c["max_abs_err_logits"] for c in cases),
            "ms": timing["kernel_ms"], "plain_ms": timing["reference_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            "library_ms": None, "device_launches_per_step": designed,
            "shape": "32 rows, t=128, D=2048, 8 blocks, 4 heads, V=4096, "
                     "7 slots, L=257; int8 weights, float32 scales"}


def phase_fixture():
    """The reference's executed ORViT-MF on the port's plain path, f32."""
    from focus_tpu_torch.config import get_cfg
    from focus_tpu_torch.models.build import build_model

    d = dict(np.load(os.path.join(REPO, "tests", "fixtures", "orvit_mf_full.npz")))
    cfg = get_cfg()
    cfg.MODEL.MODEL_NAME = "Motionformer"
    cfg.MODEL.NUM_CLASSES = 7
    cfg.TRAIN.DATASET = "ssv2"
    cfg.MF.PATCH_SIZE, cfg.MF.EMBED_DIM, cfg.MF.DEPTH = 56, 24, 3
    cfg.MF.NUM_HEADS, cfg.MF.TEMPORAL_RESOLUTION = 2, 2
    cfg.MF.USE_MLP, cfg.MF.QKV_BIAS = True, True
    cfg.ORVIT.ENABLE, cfg.ORVIT.LAYERS, cfg.ORVIT.O = True, [1], 3
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = build_model(cfg, device=DEV)
    model.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in d.items()
                           if k.startswith("sd/")}, strict=True)
    model.use_kernels = False  # head dim 12: the kernels take 64
    video = torch.from_numpy(d["video"].transpose(0, 2, 3, 4, 1).copy()).to(DEV)
    with torch.no_grad():
        out = model(video, {"orvit_bboxes": torch.from_numpy(d["boxes"]).to(DEV)})
    err = (out.cpu() - torch.from_numpy(d["out"])).abs().max().item()
    if not err <= FIXTURE_ATOL:
        raise AssertionError(f"fixture orvit_mf_full: max|err| {err:.3e}")
    emit({"phase": "fixture", "name": "orvit_mf_full", "ok": True,
          "max_abs_err": err, "atol": FIXTURE_ATOL})


@torch.no_grad()
def phase_steve_fixtures():
    """STEVE's modules on the card (plain path, float32) against the
    reference's executed dVAE, slot attention and transformer decoder."""
    from focus_tpu_torch.models.common import TransformerDecoder
    from focus_tpu_torch.models.steve.dvae import DVAE
    from focus_tpu_torch.models.steve.slot_attention import SlotAttentionVideo
    from focus_tpu_torch.utils.weights import reference_state_dict

    def load(name, module):
        d = dict(np.load(os.path.join(REPO, "tests", "fixtures", f"{name}.npz")))
        sd = {k[3:]: torch.from_numpy(v) for k, v in d.items()
              if k.startswith("sd/")}
        module.load_state_dict(reference_state_dict(sd), strict=True)
        return {k: torch.from_numpy(v).to(DEV) for k, v in d.items()
                if not k.startswith("sd/")}, module.to(DEV).eval()

    errs = {}
    d, dvae = load("dvae", DVAE(16, 3))
    logits = dvae.encoder(d["x"].permute(0, 2, 3, 1))
    recon = dvae.decoder(d["z_hard"].permute(0, 2, 3, 1))
    errs["dvae_logits"] = (logits.permute(0, 3, 1, 2) - d["logits"]).abs().max().item()
    errs["dvae_recon"] = (recon.permute(0, 3, 1, 2) - d["recon"]).abs().max().item()
    d, sav = load("slot_attention_video",
                  SlotAttentionVideo(2, 4, 12, 16, 24, 1, 2))
    slots, attns = sav(d["inputs"], noise=d["noise"])
    errs["slots"] = (slots - d["slots"]).abs().max().item()
    errs["attns"] = (attns - d["attns"]).abs().max().item()
    d, tf = load("steve_transformer_decoder", TransformerDecoder(2, 16, 2))
    errs["decoder"] = (tf(d["inp"], d["encoder_out"]) - d["out"]).abs().max().item()
    bad = {k: v for k, v in errs.items() if not v <= FIXTURE_ATOL}
    emit({"phase": "fixture", "name": "steve modules", "ok": not bad,
          "max_abs_err": errs, "atol": FIXTURE_ATOL})
    if bad:
        raise AssertionError(f"STEVE fixtures: {bad}")


def timed(fn):
    """(result, seconds) of ``fn()`` on the host clock, ending in a
    synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def steve_rollout(batch, per_step, int8=False):
    """``steve_entry(batch=batch, int8=int8)`` on the card: throughput,
    launches, peak memory and the time split of its reconstruction. Returns
    the report, the counts of the timed rollouts, and the model and its
    slots for the comparison with the plain path. The rollout replays its
    captured CUDA graph; the same reconstructions with the steps launched
    one by one are timed beside it, and the two rollouts' ids and logits
    are held bit-equal (``graph_vs_per_call``). The bf16 rollout is also
    timed through the unfused module path."""
    from focus_tpu_torch.entry import steve_entry
    from focus_tpu_torch.ops import ar_decode as ar

    fn, (video,) = steve_entry(device=DEV, batch=batch, int8=int8)
    model = fn.model
    B, T, H, W, C = video.shape
    rows = B * T
    gen_len = (model.image_size // 4) ** 2
    # warm-up: packs the weights, captures the rollout graph
    _, first_s = timed(lambda: fn(video))
    torch.cuda.reset_peak_memory_stats()
    reset_ar_counts(ar)
    recon, seconds = timed(lambda: [fn(video)
                                    for _ in range(STEVE_ITERS)][-1])
    mode, other = ("w8a8", "bf16") if int8 else ("bf16", "w8a8")
    got = ar_counts(ar)
    counts = {"wrapper": got[mode], "device": got[f"{mode}_device"]}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect = {"wrapper": gen_len * STEVE_ITERS,
              "device": gen_len * STEVE_ITERS * per_step}
    if (counts != expect or got[other] or got[f"{other}_device"]
            or got[f"{mode}_pdl"] != counts["device"]
            or got["graph_replays"] != STEVE_ITERS):
        raise AssertionError(f"decode-step launches {got}, expected {mode} "
                             f"{expect} ({STEVE_ITERS} rollouts x {gen_len} "
                             f"steps x {per_step} kernels, all with PDL, in "
                             f"{STEVE_ITERS} graph replays) and no {other}")
    recon = recon.float()
    ok = (tuple(recon.shape) == (B, T, H, W, C)
          and bool(torch.isfinite(recon).all())
          and recon.min().item() >= 0.0 and recon.max().item() <= 1.0)
    if not ok:
        raise AssertionError("STEVE reconstruction: bad shape or values")
    # the same reconstructions with the steps launched one by one
    model.rollout_graphs = False
    fn(video)
    _, per_call_s = timed(lambda: [fn(video) for _ in range(STEVE_ITERS)])
    model.rollout_graphs = True
    (slots, _, _), encode_s = timed(
        lambda: model.encode(video, generator=fn.generator))
    slots = slots.reshape(rows, model.num_slots, -1)
    graph_check = graph_vs_per_call(model, slots)
    ids, rollout_s = timed(lambda: model.decode_ids(slots))
    side = model.image_size // 4
    with torch.no_grad():
        _, dvae_s = timed(lambda: model.dvae.decoder(
            torch.nn.functional.one_hot(ids.t(), model.vocab_size)
            .to(model.dtype).reshape(rows, side, side, model.vocab_size)))
    unfused_s = None
    if not int8:  # the module path is bf16 in both modes
        model.fused_ar_step = False
        model.decode_ids(slots)  # casts the module path's weights once
        _, unfused_s = timed(lambda: model.decode_ids(slots))
        model.fused_ar_step = True
    report = {"video": [B, T, H, W, C], "rollout_rows": rows,
              "timed_rollouts": STEVE_ITERS,
              "frames_per_sec": rows * STEVE_ITERS / seconds,
              "ms_per_rollout": 1e3 * seconds / STEVE_ITERS,
              "rollout": "one CUDA-graph replay of the 256 steps",
              "per_call_frames_per_sec": rows * STEVE_ITERS / per_call_s,
              "per_call_ms_per_rollout": 1e3 * per_call_s / STEVE_ITERS,
              "graph_replays": got["graph_replays"],
              "pdl_launches": got[f"{mode}_pdl"],
              "graph_vs_per_call": graph_check,
              "first_call_ms_incl_weight_packing_and_capture":
                  1e3 * first_s,
              "peak_memory_gb": peak_gb,
              "decode_step_launches": counts["wrapper"],
              "device_launches": counts["device"],
              "device_launches_per_rollout": counts["device"] // STEVE_ITERS,
              "split_ms": {"encode": 1e3 * encode_s,
                           "rollout": 1e3 * rollout_s,
                           "dvae_decode": 1e3 * dvae_s},
              "ms_per_step_in_rollout": 1e3 * rollout_s / gen_len}
    if unfused_s is not None:
        report["unfused_module_rollout_ms"] = 1e3 * unfused_s
        report["fused_over_unfused"] = unfused_s / rollout_s
    return report, counts, model, slots


def graph_vs_per_call(model, slots):
    """The rollout replayed from its captured graph against the same
    rollout launched step by step, from the same slots: ids and every
    step's logits bit-equal, and the rollout's time both ways."""
    from focus_tpu_torch.ops import ar_decode as ar

    gen_len, rows = (model.image_size // 4) ** 2, slots.shape[0]
    runs = {}
    for graphs in (True, False):
        model.rollout_graphs = graphs
        lg = torch.empty(gen_len, rows, model.vocab_size, device=DEV)
        ids = model.decode_ids(slots, logits=lg)
        _, seconds = timed(lambda: model.decode_ids(slots))
        runs[graphs] = (ids, lg, seconds)
    model.rollout_graphs = True
    (ids_g, lg_g, graph_s), (ids_c, lg_c, call_s) = runs[True], runs[False]
    same = torch.equal(ids_g, ids_c) and torch.equal(lg_g, lg_c)
    if not same:
        raise AssertionError(
            f"graph rollout differs from the per-call rollout: ids equal "
            f"{(ids_g == ids_c).float().mean().item():.4f}, logits max|err| "
            f"{(lg_g - lg_c).abs().max().item()}")
    del runs, lg_g, lg_c
    return {"ids_and_logits_bit_equal": same, "steps": gen_len,
            "graph_rollout_ms": 1e3 * graph_s,
            "per_call_rollout_ms": 1e3 * call_s,
            "graph_captures_so_far": ar.GRAPH_CAPTURES}


def ids_vs_plain_path(model, slots, tol=AR_TOL_REL):
    """Free-running rollout, kernel against plain version. Rows are
    independent and a row's two paths share their state up to its first
    differing id: up to and at that step the kernel's logits must be within
    the single-step tolerance ``tol`` of the plain ones, and at that step
    the plain top-2 margin can be at most twice the logits' error measured
    there."""
    gen_len, rows = (model.image_size // 4) ** 2, slots.shape[0]
    lg_k = torch.empty(gen_len, rows, model.vocab_size, device=DEV)
    lg_p = torch.empty_like(lg_k)
    ids_k = model.decode_ids(slots, logits=lg_k)
    model.use_kernels = False
    ids_p = model.decode_ids(slots, logits=lg_p)
    model.use_kernels = True
    torch.cuda.synchronize()
    differ = ids_k != ids_p
    # steps a row's paths share: all up to its first difference (or the end)
    first = torch.where(differ.any(dim=0), differ.float().argmax(dim=0),
                        gen_len - 1)
    shared = torch.arange(gen_len, device=DEV)[:, None] <= first[None]
    err = (lg_k - lg_p).abs().amax(dim=-1)  # [gen_len, rows]
    scale = lg_p.abs().amax(dim=(1, 2))  # [gen_len]
    worst_err = (err / scale[:, None])[shared].max().item()
    firsts, worst_margin = [], 0.0
    for b in differ.any(dim=0).nonzero().flatten().tolist():
        t = int(first[b].item())
        top2 = lg_p[t, b].topk(2).values
        margin = (top2[0] - top2[1]).item()
        allowed = 2 * err[t, b].item()
        firsts.append({"row": b, "step": t, "plain_top2_margin": margin,
                       "allowed": allowed, "logits_err": err[t, b].item()})
        worst_margin = max(worst_margin, margin / max(allowed, 1e-30))
    ok = worst_err <= tol and worst_margin <= 1.0
    return ok, {
        "ids_equal_share": 1.0 - differ.float().mean().item(),
        "rows_with_a_difference": len(firsts), "rows": rows,
        "shared_state_steps": int(shared.sum().item()),
        "max_logits_err_over_max_logits_on_shared_steps": worst_err,
        "max_abs_logits_err_on_shared_steps": err[shared].max().item(),
        "first_differences": firsts[:8],
        "rule": "while a row's two paths share their state, logits max|err| "
                f"<= {tol} x max|logits| of the step; at a row's first "
                "differing step the plain path's top-2 margin <= 2 x that "
                "row's logits error at that step"}


def phase_steve(smi, per_step):
    """The STEVE slice at full width through ``steve_entry`` and the fused
    decode step, at 32 rollout rows (batch 8) and at 128 (batch 32), and
    its ids against the plain path. ``per_step`` is the device launches one
    wrapper call made in the kernel phase."""
    main_run, counts, model, slots = steve_rollout(8, per_step)
    ok, vs_plain = ids_vs_plain_path(model, slots)
    model.free_rollout_graphs()  # the 32-row graphs' buffers go first
    del model, slots  # the first model's weights go before the second's come
    torch.cuda.empty_cache()
    rows_128 = steve_rollout(32, per_step)[0]
    emit({"phase": "slice", "name": "steve", "ok": ok,
          "model": "steve_entry: STEVE, config defaults: 64 px (256 tokens, "
                   "L=257), 7 slots of 192, 3 corrector iterations, 4 "
                   "predictor blocks, base CNN, decoder D=2048 x 8 blocks x "
                   "4 heads, vocabulary 4096, bf16; JAX-package "
                   "initialisers, seed 0",
          "rows_32": main_run, "rows_128": rows_128,
          "vs_plain_path": vs_plain, "gpu": smi})
    if not ok:
        raise AssertionError("STEVE slice: logits or ids differ beyond the "
                             "tolerance")
    return counts


def phase_steve_w8a8(smi, per_step):
    """STEVE's rollout through ``steve_entry(int8=True)``: the W8A8 fused
    step at 32 rollout rows (batch 8) and at 128 (batch 32); its ids against
    the W8A8 plain path, and the share equal to the bf16 rollout's ids from
    the same slots (for information). ``per_step`` is the device launches
    one W8A8 wrapper call made in the kernel phase."""
    main_run, counts, model, slots = steve_rollout(8, per_step, int8=True)
    ok, vs_plain = ids_vs_plain_path(model, slots, AR_W8A8_TOL_REL)
    ids_w8a8 = model.decode_ids(slots)
    model.int8_serving = False
    ids_bf16 = model.decode_ids(slots)
    model.int8_serving = True
    same_as_bf16 = (ids_w8a8 == ids_bf16).float().mean().item()
    model.free_rollout_graphs()
    del model, slots
    torch.cuda.empty_cache()
    rows_128 = steve_rollout(32, per_step, int8=True)[0]
    emit({"phase": "slice", "name": "steve_w8a8", "ok": ok,
          "model": "steve_entry(int8=True): STEVE at the config defaults (as "
                   "the steve phase) with TPU.INT8_SERVING: the W8A8 fused "
                   "decode step, a labeled serving variant",
          "steve_rollout_kv_int8_fps": main_run["frames_per_sec"],
          "steve_rollout_kv_int8_fps_128_rows": rows_128["frames_per_sec"],
          "rows_32": main_run, "rows_128": rows_128,
          "vs_plain_path": vs_plain,
          "ids_equal_to_bf16_rollout_share": same_as_bf16, "gpu": smi})
    if not ok:
        raise AssertionError("STEVE W8A8 slice: logits or ids differ beyond "
                             "the tolerance")
    return counts


CORE_KERNELS = {4: "trajectory_block", 3: "trajectory_block_v3",
                7: "trajectory_block_v7", 5: "trajectory_block_v5",
                6: "trajectory_block_v6"}


def probs_vs_plain(probs, plain, shape):
    """One head's probabilities (of ``shape``) against the plain path's:
    finite, rows summing to 1, max |difference| within SLICE_PROB_ATOL and
    top-1 agreement at least SLICE_TOP1_MIN_SHARE."""
    finite = bool(torch.isfinite(probs).all() and torch.isfinite(plain).all())
    max_abs = (probs - plain).abs().max().item()
    top1 = (probs.argmax(-1) == plain.argmax(-1)).float().mean().item()
    sums_ok = bool(((probs.sum(-1) - 1).abs() < 1e-3).all())
    ok = (tuple(probs.shape) == shape and finite and sums_ok
          and max_abs <= SLICE_PROB_ATOL and top1 >= SLICE_TOP1_MIN_SHARE)
    return ok, {"max_abs_prob": max_abs, "top1_agreement": top1,
                "finite": finite}


def flagship_run(fn, video, boxes, heads=None):
    """``fn`` (an ``entry`` or ``hr_entry`` forward) at its batch: 2 warm-up
    and SLICE_ITERS timed batches with the kernels' launch counts reset
    just before them (one trajectory core per block, 12, of the version
    ``FWD_VERSION`` names and none of the others, and one patch embed per
    forward, asserted), then the same model on the plain path, whose
    probabilities the kernel path's are held against (``probs_vs_plain``):
    the flagship's 174, or with ``heads`` ({name: classes}) each head of an
    EPIC-Kitchens model's pair (verb, {name: probabilities}). Returns
    (report, launches, the last timed output)."""
    from focus_tpu_torch.ops import patch_embed as pe
    from focus_tpu_torch.ops import trajectory_block as tb

    model = fn.model
    B = video.shape[0]
    for _ in range(2):
        fn(video, boxes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    tb.LAUNCHES = tb.V3_LAUNCHES = tb.V5_LAUNCHES = tb.V6_LAUNCHES = 0
    tb.V7_LAUNCHES = pe.LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(SLICE_ITERS):
        probs = fn(video, boxes)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"trajectory_block": tb.LAUNCHES,
                "trajectory_block_v3": tb.V3_LAUNCHES,
                "trajectory_block_v7": tb.V7_LAUNCHES,
                "trajectory_block_v5": tb.V5_LAUNCHES,
                "trajectory_block_v6": tb.V6_LAUNCHES,
                "patch_embed": pe.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect = {k: 0 for k in CORE_KERNELS.values()}
    expect[CORE_KERNELS[tb.FWD_VERSION]] = len(model.blocks) * SLICE_ITERS
    expect["patch_embed"] = SLICE_ITERS
    if launches != expect:
        raise AssertionError(f"launch counts {launches}, expected {expect}")

    model.use_kernels = False
    plain = fn(video, boxes)
    model.use_kernels = True
    torch.cuda.synchronize()
    vs_plain = {"atol": SLICE_PROB_ATOL,
                "top1_min_share": SLICE_TOP1_MIN_SHARE}
    if heads is None:
        ok, check = probs_vs_plain(probs, plain, (B, 174))
        finite = check.pop("finite")
        vs_plain.update(check)
    else:
        ok, finite = True, True
        for name, classes in heads.items():
            head_ok, check = probs_vs_plain(probs[1][name], plain[1][name],
                                            (B, classes))
            ok, finite = ok and head_ok, finite and check["finite"]
            vs_plain[name] = {"ok": head_ok, "classes": classes, **check}
    report = {"ok": ok, "batch": B, "timed_batches": SLICE_ITERS,
              "clips_per_sec": B * SLICE_ITERS / seconds,
              "ms_per_batch": 1e3 * seconds / SLICE_ITERS,
              "peak_memory_gb": peak_gb,
              "allocated_before_the_timed_batches_gb": resident_gb,
              "launches": launches,
              "launches_per_forward": {k: v / SLICE_ITERS
                                       for k, v in launches.items()},
              "vs_plain_path": vs_plain,
              "finite": finite}
    return report, launches, probs


# bench.py's serving matrix: the exact-erf bf16 headline, then the labeled
# variants under bench.py's metric names
VARIANTS = (("erf_bf16_clips_per_sec", False, False),
            ("fast_gelu_clips_per_sec", True, False),
            ("int8_serving_clips_per_sec", False, True),
            ("tanh_int8_clips_per_sec", True, True))


def phase_serving(smi):
    """bench.py's serving matrix through ``entry(fast_gelu=..., int8=...)``
    at batch 8, one model after the other in this phase (so that the
    variants are compared on one host state), each as ``flagship_run``
    drives it; each variant's probabilities against the exact-erf bf16
    model's on the same weights and inputs."""
    from focus_tpu_torch.entry import entry

    @torch.no_grad()  # no graph: it would keep the parameters alive
    def fingerprint(model):  # one float64 sum per parameter
        return torch.stack([p.double().sum() for p in model.parameters()])

    result = {"phase": "slice", "name": "serving_matrix",
              "model": "ORViT-MF SSv2 16x224, D=768, 12 layers, 12 heads, "
                       "ORViT at [1,6,10], O=4, bf16; exact-erf GELU, then "
                       "the labeled serving variants (TPU.FAST_GELU: tanh "
                       "GELU; TPU.INT8_SERVING: W8A8 qkv, proj, fc1, fc2 "
                       "through torch._int_mm)"}
    launches, problems = {}, []
    for metric, fast_gelu, int8 in VARIANTS:
        fn, (video, boxes) = entry(device=DEV, batch=8, seed=0,
                                   fast_gelu=fast_gelu, int8=int8)
        weights = fingerprint(fn.model)
        report, counts, probs = flagship_run(fn, video, boxes)
        if not (fast_gelu or int8):
            base_weights, base_probs = weights, probs
        elif not torch.equal(weights, base_weights):
            raise AssertionError(f"{metric}: weights differ from the erf "
                                 "bf16 model's")
        else:
            vs_erf = (probs - base_probs).abs().max().item()
            report["vs_erf_bf16_max_abs_prob"] = vs_erf
            report["vs_erf_bf16_atol"] = VARIANT_PROB_ATOL
            report["ok"] = report["ok"] and vs_erf < VARIANT_PROB_ATOL
        if not report["ok"]:
            problems.append(metric)
        result[metric] = report.pop("clips_per_sec")
        result[metric.replace("clips_per_sec", "detail")] = {
            "fast_gelu": fast_gelu, "int8_serving": int8, **report}
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        del fn
        torch.cuda.empty_cache()
    emit({**result, "ok": not problems, "gpu": smi})
    if problems:
        raise AssertionError(f"serving variants failed: {problems}")
    return launches


def phase_slice(smi):
    from focus_tpu_torch.entry import entry

    fn, (video, boxes) = entry(device=DEV, batch=8, seed=0)
    report, launches, _ = flagship_run(fn, video, boxes)
    emit({"phase": "slice",
          "model": "ORViT-MF SSv2 16x224, D=768, 12 layers, 12 heads, "
                   "ORViT at [1,6,10], O=4, bf16, exact-erf GELU",
          **report, "gpu": smi})
    if not report["ok"]:
        raise AssertionError("slice check failed")
    return launches


# kernel 1 at N > 256 keys a frame (its chunked stage 1): the 336 crop's
# N = 441 (the plain blocks) and 445 (the ORViT blocks, 4 box tokens a
# frame) at the HR batch, and the narrowest and widest chunked forms
HR_KERNEL_CASES = ((4, 441), (4, 445), (2, 257), (2, 512))
HR_BATCH = 4  # scripts/bench_companions.py hr336
KERNEL_1_DEVICE_LAUNCHES_PER_CALL = 3
HR_HEADS = {"verb": 97, "noun": 300}


PROFILE_ATTEMPTS = 3


def device_kernels(fn):
    """Names of the device kernels one call of ``fn`` launches, as
    torch.profiler traces them on the card. A trace that holds no device
    event at all (the profiler now and then returns one, after a call that
    did launch) is taken again, up to PROFILE_ATTEMPTS traces; the callers
    check the names of the first trace that holds any."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


def check_kernel_1_launches(tb, args, scale, heads, tag):
    """One call of kernel 1's wrapper launches its three device kernels
    (at N > 256 the chunked stage 1 first); returns their names."""
    names = device_kernels(lambda: tb._launch(*args[:6], scale, heads))
    stage1 = ("space_stage_chunked_kernel" if args[1].shape[2] > 256
              else "space_stage_kernel")
    if (len(names) != KERNEL_1_DEVICE_LAUNCHES_PER_CALL
            or stage1 not in names[0]):
        raise AssertionError(f"trajectory_block {tag}: device kernels "
                             f"{names}, expected {stage1}, the GEMM and "
                             "stage 2")
    return names


def hr_refusals(tb, gen):
    """On the card: the wrappers of kernels 1 and 3 to 8 raise ValueError
    at N = 513 keys a frame before any launch."""
    from focus_tpu_torch.ops import trajectory_attention as ta

    N = 513
    wide = core_inputs(1, N, gen)
    q, kf, vf = wide[:3]
    (B, S, C), F = q.shape, kf.shape[1]
    xs_wide = torch.empty(B, S, F, C, dtype=torch.bfloat16, device=DEV)
    BH = B * C // 64
    calls = {
        "trajectory_block": lambda: tb._launch(*wide[:6], 0.125, 12),
        "trajectory_block_v3": lambda: tb._launch_v3(*wide[:6], 0.125, 12),
        "trajectory_block_v7": lambda: tb._launch_v7(*wide[:6], 0.125, 12),
        "trajectory_block_v5": lambda: tb._launch_variant(5, *wide[:6],
                                                          0.125, 12),
        "trajectory_block_v6": lambda: tb._launch_variant(6, *wide[:6],
                                                          0.125, 12),
        "trajectory_block_bwd": lambda: tb._launch_backward(
            *wide[:6], wide[0], xs_wide, wide[0], 0.125, 12),
        "space_stage": lambda: ta._launch(
            q.reshape(BH, S, 64), kf.reshape(BH, F, N, 64),
            vf.reshape(BH, F, N, 64), 0.125),
    }

    def counts():
        return (tb.LAUNCHES, tb.BWD_LAUNCHES, variant_counts(tb),
                ta.LAUNCHES)

    before = counts()
    refused = {}
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            refused[name] = str(e).split(";")[0]
    torch.cuda.synchronize()
    if set(refused) != set(calls) or counts() != before:
        raise AssertionError(f"N = 513: refused {sorted(refused)}, launch "
                             f"counts {before} -> {counts()}")
    return refused


def phase_hr336(smi):
    """The HR-336 EPIC-Kitchens eval forward (BASELINE.json config 4):
    kernel 1 at N > 256 against its plain version (out, xs, q2 within
    KERNEL_TOL_REL, two calls bit-equal, three device kernels a call,
    ms per call and back to back beside bound_ms), at HR_KERNEL_CASES and
    on the extreme inputs at N = 441; then ``hr_entry(batch=4)`` at full
    width and depth with kernel 2 on the [4, 16, 336, 336, 3] video: 2
    warm-up and SLICE_ITERS timed batches with the launch counts reset just
    before them (12 kernel-1 and 1 kernel-2 launches a forward and none of
    the other forward versions), clips per second and peak memory, and the
    verb and noun probabilities against the same model on the plain path
    (SLICE_PROB_ATOL, top-1 agreement SLICE_TOP1_MIN_SHARE, each head);
    then kernels 1 and 3 to 8 refusing N = 513 before any launch. Returns
    kernel 1's and kernel 2's HR numbers for the kernels line."""
    from focus_tpu_torch.entry import hr_entry
    from focus_tpu_torch.ops import trajectory_block as tb

    heads, scale = 12, 64 ** -0.5
    gen = torch.Generator(device=DEV)
    gen.manual_seed(14)
    cases, errs, timing = [], [], {}
    for B, N in HR_KERNEL_CASES:
        args = core_inputs(B, N, gen)
        out = tb.fused_trajectory_core(*args, scale, heads)
        ref = tb.trajectory_core_reference(*[a.float() for a in args],
                                           scale, heads)
        torch.cuda.synchronize()
        tag = f"B={B} N={N}"
        err, ref_max = check_close(f"trajectory_block {tag}", out, ref)
        del ref
        errs.append(err)
        S, C = 8 * N, 768
        case = {"B": B, "S": S, "N": N, "max_abs_err": err,
                "max_abs_ref": ref_max,
                **check_stage1_outputs(tb, args, scale, heads, tag),
                "device_kernels": check_kernel_1_launches(tb, args, scale,
                                                          heads, tag),
                "kernel_ms": time_ms(
                    lambda: tb.fused_trajectory_core(*args, scale, heads)),
                "kernel_ms_back_to_back": time_ms_back_to_back(
                    lambda: tb.fused_trajectory_core(*args, scale, heads)),
                "plan": tb.trajectory_core_plan(B, S, 8, N, heads)}
        case["bound_ms"], case["bound_by"] = bound(
            core_flops(B, S, 8, N, C), nbytes(*args) + nbytes(out))
        if (B, N) == (HR_BATCH, 441):
            case["plain_ms"] = time_ms(
                lambda: tb.trajectory_core_reference(*args, scale, heads),
                warmup=1, iters=5)
        timing[(B, N)] = case
        cases.append(case)
        del args, out
    for sign, mag in ((-1.0, 25.0), (-1.0, 60.0), (1.0, 50.0)):
        args = extreme_inputs(sign, mag, gen, N=441)
        out = tb.fused_trajectory_core(*args, scale, heads)
        ref = tb.trajectory_core_reference(*[a.float() for a in args],
                                           scale, heads)
        torch.cuda.synchronize()
        tag = f"extreme {sign * mag} N=441"
        err, ref_max = check_close(f"trajectory_block {tag}", out, ref)
        errs.append(err)
        cases.append({"extreme_logit_nats": sign * mag, "N": 441,
                      "max_abs_err": err, "max_abs_ref": ref_max,
                      **check_stage1_outputs(tb, args, scale, heads, tag),
                      "device_kernels": check_kernel_1_launches(
                          tb, args, scale, heads, tag)})
        del args, out, ref
    torch.cuda.empty_cache()

    fn, (video, boxes) = hr_entry(device=DEV, batch=HR_BATCH, seed=0)
    run, launches, _ = flagship_run(fn, video, boxes, HR_HEADS)
    refused = hr_refusals(tb, gen)
    clips_per_sec = run.pop("clips_per_sec")
    report = {"phase": "hr336", "ok": run.pop("ok"),
              "model": "ORViT-MF-HR EK100 16x336 (configs/ORViT/"
                       "EK_ORVIT_MF_HR.yaml), D=768, 12 layers, 12 heads, "
                       "ORViT at [1,6,10], O=4, verb [97] and noun [300] "
                       "heads, bf16, exact-erf GELU; N = 441 keys a frame "
                       "(445 in the ORViT blocks)",
              "hr336_ek_b4_clips_per_sec": clips_per_sec, **run,
              "refused_at_n513": refused,
              "kernel_1": {"tolerance": f"max|err| <= {KERNEL_TOL_REL} x "
                                        "max|ref| for out, xs and q2; two "
                                        "calls bit-equal; "
                                        f"{KERNEL_1_DEVICE_LAUNCHES_PER_CALL}"
                                        " device kernels a call",
                           "cases": cases},
              "gpu": smi}
    emit(report)
    if not report["ok"]:
        raise AssertionError("HR-336 forward check failed")
    del fn, video, boxes
    torch.cuda.empty_cache()
    t441, t445 = timing[(HR_BATCH, 441)], timing[(HR_BATCH, 445)]
    return {"launches": launches, "max_abs_err": max(errs),
            "ms": t441["kernel_ms"],
            "ms_back_to_back": t441["kernel_ms_back_to_back"],
            "plain_ms": t441["plain_ms"], "bound_ms": t441["bound_ms"],
            "bound_by": t441["bound_by"],
            "ms_n445": t445["kernel_ms"],
            "ms_back_to_back_n445": t445["kernel_ms_back_to_back"],
            "bound_ms_n445": t445["bound_ms"]}


def phase_flagship_fwd_versions(smi):
    """The flagship forward at batch 8 through ``entry()`` under
    FWD_VERSION 4, 3, 7, 5 and 6, one after the other on one model, each as
    ``flagship_run`` drives it (12 launches of the chosen forward kernel
    per forward and none of the others; probabilities against the plain
    path); then one ``train_entry`` step at batch 2 under 5 and under 6
    with its launch counts (v5: 12 forward, 12 kernel-1 recompute and 12
    backward launches; the train steps under 3 and 7 are
    ``phase_train``'s).
    FWD_VERSION is 4 again after the phase, whatever happens."""
    from focus_tpu_torch.entry import entry, train_entry
    from focus_tpu_torch.ops import trajectory_block as tb

    fn, (video, boxes) = entry(device=DEV, batch=8, seed=0)
    result = {"phase": "slice", "name": "flagship_fwd_versions",
              "model": "ORViT-MF SSv2 16x224, D=768, 12 layers, 12 heads, "
                       "ORViT at [1,6,10], O=4, bf16, exact-erf GELU; the "
                       "trajectory core's forward kernel by FWD_VERSION"}
    launches, problems, probs = {}, [], {}
    try:
        for version in CORE_KERNELS:
            tb.FWD_VERSION = version
            report, counts, probs[version] = flagship_run(fn, video, boxes)
            if version != 4:
                report["vs_fwd_version_4_max_abs_prob"] = (
                    probs[version] - probs[4]).abs().max().item()
            result[f"fwd_version_{version}"] = report
            if not report["ok"]:
                problems.append(version)
            launches[version] = counts[CORE_KERNELS[version]]
        del fn
        torch.cuda.empty_cache()
        # one train step per variant at batch 2: v5 forms no xs, so its
        # backward recomputes xs and q2 with a kernel-1 launch per block
        for version in (5, 6):
            tb.FWD_VERSION = version
            fn, batch = train_entry(device=DEV, batch=2, seed=0)
            before = variant_counts(tb)
            loss = fn(*batch)["loss"].item()
            torch.cuda.synchronize()
            got = {k: v - before[k] for k, v in variant_counts(tb).items()
                   if k in ("v4", "v3", "v7", "v5", "v6", "bwd")}
            depth = len(fn.model.blocks)
            expect = {"v4": depth if version == 5 else 0, "v3": 0, "v7": 0,
                      "v5": depth if version == 5 else 0,
                      "v6": depth if version == 6 else 0, "bwd": depth}
            result[f"train_step_fwd_version_{version}"] = {
                "batch": 2, "loss": loss, "launches": got,
                "expected": expect}
            if got != expect or not math.isfinite(loss):
                problems.append(f"train step {version}")
            del fn, batch
            torch.cuda.empty_cache()
    finally:
        tb.FWD_VERSION = 4
    emit({**result, "ok": not problems, "gpu": smi})
    if problems:
        raise AssertionError(f"flagship forward or train step failed under "
                             f"FWD_VERSION {problems}")
    return launches


def phase_hr336_fwd_versions(smi, per_call):
    """The HR-336 eval forward at batch 4 through ``hr_entry()`` under
    FWD_VERSION 4, 3, 7, 5 and 6, one after the other on one model, each as
    ``flagship_run`` drives it (12 launches of the chosen forward kernel
    per forward, nine at N = 441 and three at 445, and none of the others;
    verb and noun probabilities against the plain path); every version's
    distance from version 4's probabilities is reported (v5 and v6 compute
    another function at more than one head, ROADMAP.md section 3 defect
    5). Then one ``hr_train_entry`` step at batch 2 from the same seed
    under 4, 3, 7, 5 and 6, with its launch counts asserted (12 forward
    calls of the version's kernel, each of its device count; 12 kernel-7
    calls of ``per_call`` device kernels; under 5 also 12 kernel-1
    recomputes of xs and q2), the loss and every gradient finite, and
    under 3 and 7 the loss within TRAIN_LOSS_REL of version 4's on the same
    batch. FWD_VERSION is 4 again after the phase, whatever happens.
    Returns the launches of each version's kernel: over the SLICE_ITERS
    timed forwards, and in its train step."""
    from focus_tpu_torch.entry import hr_entry, hr_train_entry
    from focus_tpu_torch.ops import trajectory_block as tb

    result = {"phase": "slice", "name": "hr336_fwd_versions",
              "model": "ORViT-MF-HR EK100 16x336 (configs/ORViT/"
                       "EK_ORVIT_MF_HR.yaml), D=768, 12 layers, 12 heads, "
                       "ORViT at [1,6,10], O=4, verb [97] and noun [300] "
                       "heads, bf16, exact-erf GELU; N = 441 keys a frame "
                       "(445 in the ORViT blocks); the trajectory core's "
                       "forward kernel by FWD_VERSION"}
    launches, problems, probs = {}, [], {}
    device_per_call = {3: SAME_FUNCTION_DEVICE_LAUNCHES,
                       7: SAME_FUNCTION_DEVICE_LAUNCHES,
                       5: K2V_DEVICE_LAUNCHES, 6: K2V_DEVICE_LAUNCHES}
    try:
        fn, (video, boxes) = hr_entry(device=DEV, batch=HR_BATCH, seed=0)
        for version in CORE_KERNELS:
            tb.FWD_VERSION = version
            report, counts, out = flagship_run(fn, video, boxes, HR_HEADS)
            probs[version] = out[1]
            if version != 4:
                report["vs_fwd_version_4_max_abs_prob"] = {
                    name: (probs[version][name] - probs[4][name]).abs()
                    .max().item() for name in HR_HEADS}
            if version in (5, 6):
                report["vs_fwd_version_4_note"] = (
                    "another function than version 4's at more than one "
                    "head (ROADMAP.md section 3 defect 5)")
            result[f"fwd_version_{version}"] = report
            if not report["ok"]:
                problems.append(version)
            launches[version] = {"hr336": counts[CORE_KERNELS[version]]}
        del fn, video, boxes, probs
        torch.cuda.empty_cache()
        # one train step per version at batch 2, from the same seed
        loss_v4 = None
        for version in CORE_KERNELS:
            tb.FWD_VERSION = version
            fn, batch = hr_train_entry(device=DEV, batch=2, seed=0)
            depth = len(fn.model.blocks)
            before = variant_counts(tb)
            before["bwd_device"] = tb.BWD_DEVICE_LAUNCHES
            loss = fn(*batch)["loss"].item()
            torch.cuda.synchronize()
            after = variant_counts(tb)
            after["bwd_device"] = tb.BWD_DEVICE_LAUNCHES
            got = {k: v - before[k] for k, v in after.items()}
            key = f"v{version}"
            expect = {k: 0 for k in got}
            expect.update({key: depth, "bwd": depth,
                           "bwd_device": depth * per_call})
            if version == 5:  # v5 forms no xs: kernel 1 recomputes it
                expect["v4"] = depth
            if version != 4:
                expect[f"{key}_device"] = depth * device_per_call[version]
            nonfinite = [n for n, g in grads_of(fn.model).items()
                         if not bool(torch.isfinite(g).all())]
            step = {"batch": 2, "loss": loss, "launches": got,
                    "expected": expect, "nonfinite_grads": nonfinite[:5]}
            if version == 4:
                loss_v4 = loss
            else:
                step["loss_rel_to_fwd_version_4"] = (abs(loss - loss_v4)
                                                     / abs(loss_v4))
            bad = got != expect or not math.isfinite(loss) or nonfinite
            if version in SAME_FUNCTION:
                bad = bad or step["loss_rel_to_fwd_version_4"] > TRAIN_LOSS_REL
            if bad:
                problems.append(f"train step {version}")
            result[f"train_step_fwd_version_{version}"] = step
            launches[version]["hr336_train"] = got[key]
            del fn, batch
            torch.cuda.empty_cache()
    finally:
        tb.FWD_VERSION = 4
    emit({**result, "ok": not problems,
          "rule": "each forward as flagship_run holds it (12 launches of the "
                  "version's kernel and none of the others', probabilities "
                  f"within {SLICE_PROB_ATOL} of the plain path's, top-1 "
                  f"agreement >= {SLICE_TOP1_MIN_SHARE}, each head); each "
                  "train step's launch counts, a finite loss and finite "
                  "gradients, and under 3 and 7 the loss within "
                  f"{TRAIN_LOSS_REL} (relative) of version 4's",
          "gpu": smi})
    if problems:
        raise AssertionError(f"HR-336 forward or train step failed under "
                             f"FWD_VERSION {problems}")
    return launches


def phase_learned_v(smi):
    """The learned-v slice: 12 ``TrajectoryAttentionBlock(768, 12,
    qkv_bias=True, use_original_code=False)`` with seeded init-scale
    weights on x [8, 1569, 768] bf16, thw (8, 14, 14)
    (``profile_block.learned_v_stack``): eval ms per stack with 12 space-
    stage launches per stack, peak memory, the output against the plain
    path (``learned_v_eval``); the same at the 336 crop, thw (8, 21, 21),
    x [4, 3529, 768] (N = 441 keys a frame, kernel 8's chunked form); then
    at batch 2 one forward and backward of sum(out * target) / numel
    through the kernel (bf16) against the float32 plain path, the bf16
    plain path beside it. Returns the launches of the timed stacks at 224
    and at 336."""
    from focus_tpu_torch.ops import trajectory_attention as ta
    from focus_tpu_torch.profile_block import learned_v_stack

    hr_model, hr_x = learned_v_stack(device=DEV, batch=HR_BATCH, seed=0,
                                     hr=True)
    hr_eval = learned_v_eval(ta, hr_model, hr_x)
    del hr_model, hr_x
    torch.cuda.empty_cache()
    model, x = learned_v_stack(device=DEV, batch=8, seed=0)
    depth = len(model.blocks)
    run = learned_v_eval(ta, model, x)

    # batch 2: forward and backward, kernel path (bf16) vs plain float32,
    # and the bf16 plain path beside it
    x2 = x[:2].clone()
    target = torch.randn(x2.shape, generator=torch.Generator(
        device=DEV).manual_seed(1), device=DEV)
    runs = {}
    for name in ("kernel", "plain_bf16", "plain_f32"):
        model.zero_grad(set_to_none=True)
        model.use_kernels = name == "kernel"
        inp = x2.float() if name == "plain_f32" else x2
        before = ta.LAUNCHES
        loss = (model(inp, train=True).float() * target).mean()
        loss.backward()
        torch.cuda.synchronize()
        runs[name] = {"loss": loss.item(), "launches": ta.LAUNCHES - before,
                      "grads": grads_of(model)}
    model.use_kernels = True
    model.zero_grad(set_to_none=True)
    k, pb, ref = runs["kernel"], runs["plain_bf16"], runs["plain_f32"]
    problems = []
    if k["launches"] != depth or pb["launches"] or ref["launches"]:
        problems.append(f"launches {k['launches']} / {pb['launches']} / "
                        f"{ref['launches']}")
    loss_rel = abs(k["loss"] - ref["loss"]) / abs(ref["loss"])
    if not (math.isfinite(k["loss"]) and loss_rel <= TRAIN_LOSS_REL):
        problems.append(f"loss {k['loss']} vs plain {ref['loss']}")

    def cos_rel(a, b):
        a, b = a.double().flatten(), b.double().flatten()
        return ((a @ b / (a.norm() * b.norm()).clamp_min(1e-300)).item(),
                ((a - b).norm() / b.norm().clamp_min(1e-300)).item())

    rows = []
    for name, b in ref["grads"].items():
        a = k["grads"][name]
        if not bool(torch.isfinite(a).all()):
            problems.append(f"{name}: non-finite gradient")
            continue
        cos, rel = cos_rel(a, b)
        bf_cos, bf_rel = cos_rel(pb["grads"][name], b)
        row = {"name": name, "cos": cos, "rel_l2": rel,
               "plain_bf16_cos": bf_cos, "plain_bf16_rel_l2": bf_rel}
        # the train phase's rule for relative L2, applied to the cosine: the
        # kernel path may be BF16_SLACK times as far from 1 as the bf16
        # plain path where that is farther than 1 - TRAIN_GRAD_COS (the
        # stage-2 query projection at init, whose gradient is a difference
        # of near-equal terms that bf16 rounding perturbs)
        allowed = max(1.0 - TRAIN_GRAD_COS, BF16_SLACK * (1.0 - bf_cos))
        if allowed > 1.0 - TRAIN_GRAD_COS:
            row["one_minus_cos_bound"] = allowed
        if 1.0 - cos > allowed:
            problems.append(f"{name}: gradient cos {cos:.4f} (bf16 plain "
                            f"path {bf_cos:.4f})")
        rows.append(row)
    rows.sort(key=lambda r: r["cos"])
    emit({"phase": "slice", "name": "learned_v", "ok": not problems,
          "model": "12 x TrajectoryAttentionBlock(768, 12 heads, qkv_bias, "
                   "use_original_code=False), init-scale weights N(0, "
                   "0.02^2) seed 0, x [8, 1569, 768] bf16 (numpy seed 0), "
                   "thw (8, 14, 14)",
          "batch": 8, **run,
          "hr336": {"model": "the same stack at the 336 crop: x [4, 3529, "
                             "768] bf16 (numpy seed 0), thw (8, 21, 21), N "
                             "= 441 keys a frame (kernel 8's chunked form)",
                    "batch": HR_BATCH, **hr_eval},
          "train_batch_2": {
              "loss": k["loss"], "plain_f32_loss": ref["loss"],
              "plain_bf16_loss": pb["loss"], "loss_rel_err": loss_rel,
              "space_stage_launches": k["launches"],
              "params": len(rows),
              "min_grad_cos": rows[0]["cos"],
              "max_grad_rel_l2": max(r["rel_l2"] for r in rows),
              "min_plain_bf16_grad_cos": min(r["plain_bf16_cos"]
                                             for r in rows),
              "params_bounded_by_the_bf16_plain_path": sum(
                  "one_minus_cos_bound" in r for r in rows),
              "worst_grads": rows[:4],
              "rule": f"loss within {TRAIN_LOSS_REL} relative of the "
                      "float32 plain path; every gradient finite with cosine "
                      f">= {TRAIN_GRAD_COS} against it, or 1 - cosine at "
                      f"most {BF16_SLACK} x the bf16 plain path's own where "
                      "that is larger"},
          "problems": problems, "gpu": smi})
    if problems:
        raise AssertionError(f"learned_v slice: {problems[:5]}")
    del model, x
    torch.cuda.empty_cache()
    return run["space_stage_launches"], hr_eval["space_stage_launches"]


def learned_v_eval(ta, model, x):
    """The stack's eval forward on x: 2 warm-up and SLICE_ITERS timed
    stacks with kernel 8's launch count reset just before them (one a
    block asserted), ms per stack, peak memory, and the last output
    against the plain path (KERNEL_TOL_REL, both bf16)."""
    depth = len(model.blocks)
    with torch.no_grad():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ta.LAUNCHES = 0
        t0 = time.perf_counter()
        for _ in range(SLICE_ITERS):
            out = model(x)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ta.LAUNCHES
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if launches != depth * SLICE_ITERS:
            raise AssertionError(f"space_stage launches {launches}, "
                                 f"expected {depth * SLICE_ITERS}")
        model.use_kernels = False
        plain = model(x)
        model.use_kernels = True
        torch.cuda.synchronize()
    err, ref_max = check_close(
        f"learned_v stack vs plain path, x {list(x.shape)}", out, plain)
    return {"timed_stacks": SLICE_ITERS,
            "ms_per_stack": 1e3 * seconds / SLICE_ITERS,
            "peak_memory_gb": peak_gb, "space_stage_launches": launches,
            "space_stage_launches_per_stack": launches / SLICE_ITERS,
            "vs_plain_path": {"max_abs_err": err, "max_abs_ref": ref_max,
                              "rule": f"max|err| <= {KERNEL_TOL_REL} x "
                                      "max|ref| (both bf16)"}}


def grads_of(model):
    """Each parameter's gradient in float32; a parameter its graph never
    read (no .grad) counts as a zero gradient, as JAX gives it."""
    return {n: torch.zeros_like(p) if p.grad is None else p.grad.float()
            for n, p in model.named_parameters()}


def compare_grads(gk, gp, pk, pp, rel_bound=None):
    """Per parameter: the kernel path's gradient ``gk`` against the plain
    path's ``gp`` (cosine, relative L2 within ``rel_bound[name]``, default
    TRAIN_GRAD_REL_L2, zero pattern) and the parameters after the update.
    Returns (rows, problems)."""
    rows, problems = [], []
    for name, b in gp.items():
        bound = (rel_bound or {}).get(name, TRAIN_GRAD_REL_L2)
        a = gk[name]
        a64, b64 = a.double().flatten(), b.double().flatten()
        only_one = (a64 == 0) != (b64 == 0)
        big = b64.abs().max().item()
        row = {"name": name, "exact_zero_mismatch": int(only_one.sum()),
               "max_abs_where_one_is_zero": (
                   (a64 - b64).abs()[only_one].max().item()
                   if bool(only_one.any()) else 0.0)}
        if not bool(torch.isfinite(a64).all()):
            problems.append(f"{name}: non-finite gradient")
        if bool((a64 != 0).any()) != bool((b64 != 0).any()):
            problems.append(f"{name}: all-zero gradient in one path only")
        elif row["max_abs_where_one_is_zero"] > TRAIN_GRAD_REL_L2 * big:
            problems.append(f"{name}: zero in one path where the other has "
                            f"{row['max_abs_where_one_is_zero']:.3e} "
                            f"(max {big:.3e})")
        if big > 0:
            row["cos"] = (a64 @ b64 / (a64.norm() * b64.norm())).item()
            row["rel_l2"] = ((a64 - b64).norm() / b64.norm()).item()
            if bound > TRAIN_GRAD_REL_L2:
                row["rel_l2_bound"] = bound
            if row["cos"] < TRAIN_GRAD_COS or row["rel_l2"] > bound:
                problems.append(f"{name}: gradient cos {row['cos']:.4f}, "
                                f"rel L2 {row['rel_l2']:.3e}")
        row["param_rel_l2"] = ((pk[name].double() - pp[name].double()).norm()
                               / pp[name].double().norm()).item()
        if row["param_rel_l2"] > TRAIN_PARAM_REL_L2:
            problems.append(f"{name}: parameters after the step differ by "
                            f"{row['param_rel_l2']:.3e} (rel L2)")
        rows.append(row)
    return rows, problems


def summary(rows):
    scored = [r for r in rows if "cos" in r]
    return {"params": len(rows),
            "params_with_zero_gradient_in_both": len(rows) - len(scored),
            "min_grad_cos": min(r["cos"] for r in scored),
            "max_grad_rel_l2": max(r["rel_l2"] for r in scored),
            "max_param_rel_l2_after_step": max(r["param_rel_l2"] for r in rows),
            "elements_exactly_zero_in_one_path_only":
                sum(r["exact_zero_mismatch"] for r in rows),
            "params_bounded_by_the_bf16_plain_path":
                sum("rel_l2_bound" in r for r in rows),
            "max_grad_rel_l2_of_the_others": max(
                [r["rel_l2"] for r in scored if "rel_l2_bound" not in r]),
            "worst_grads": sorted(scored, key=lambda r: -r["rel_l2"])[:4]}


def train_vs_plain_path(make=None):
    """One train step at batch 2 through the kernels (bf16) and through the
    plain path in float32, from the same weights and batch: the loss, every
    parameter's gradient and the parameters after the AdamW update. The
    plain path in bf16 is held against the float32 one beside it, for
    information: it rounds where the kernels do not. ``make`` is the entry
    point (default ``train_entry``)."""
    from focus_tpu_torch.entry import train_entry

    make = make or train_entry
    runs = {}
    for name in ("kernel", "plain_f32", "plain_bf16"):
        fn, (video, labels, boxes) = make(device=DEV, batch=2, seed=0)
        if name != "kernel":
            fn.model.load_state_dict(runs["kernel"]["init"])
            fn.model.use_kernels = False
        if name == "plain_f32":
            fn.model.dtype = torch.float32
        init = {k: v.clone() for k, v in fn.model.state_dict().items()}
        loss = fn(video, labels, boxes)["loss"].item()
        runs[name] = {"init": init, "loss": loss, "grads": grads_of(fn.model),
                      "params": {k: p.detach().clone() for k, p
                                 in fn.model.named_parameters()}}
        del fn
        torch.cuda.empty_cache()
    k, ref, pb = runs["kernel"], runs["plain_f32"], runs["plain_bf16"]
    bf16_rows, _ = compare_grads(pb["grads"], ref["grads"], pb["params"],
                                 ref["params"])
    rel_bound = {r["name"]: max(TRAIN_GRAD_REL_L2, BF16_SLACK * r["rel_l2"])
                 for r in bf16_rows if "rel_l2" in r}
    rows, problems = compare_grads(k["grads"], ref["grads"], k["params"],
                                   ref["params"], rel_bound)
    loss_rel = abs(k["loss"] - ref["loss"]) / abs(ref["loss"])
    if not (math.isfinite(k["loss"]) and loss_rel <= TRAIN_LOSS_REL):
        problems.append(f"loss {k['loss']} vs plain {ref['loss']}")
    report = {
        "batch": 2, "loss": k["loss"], "plain_f32_loss": ref["loss"],
        "plain_bf16_loss": pb["loss"], "loss_rel_err": loss_rel,
        "kernel_vs_plain_f32": summary(rows),
        "plain_bf16_vs_plain_f32": summary(bf16_rows),
        "rule": f"kernel path (bf16) vs plain path (float32), same weights "
                f"and batch: loss within {TRAIN_LOSS_REL} relative; every "
                "gradient finite, all-zero in both paths or in neither, and "
                "where exactly one path has an exact zero the other within "
                f"{TRAIN_GRAD_REL_L2} x the parameter's max |gradient|; "
                f"cosine >= {TRAIN_GRAD_COS} and relative L2 <= "
                f"{TRAIN_GRAD_REL_L2}, or <= {BF16_SLACK} x the bf16 plain "
                "path's own relative L2 from float32 where that exceeds "
                f"{TRAIN_GRAD_REL_L2}; parameters after one AdamW step "
                f"within {TRAIN_PARAM_REL_L2} of their norm (relative L2)"}
    return report, problems


def train_counts():
    """Launch counts of the train phases: every forward kernel's wrapper
    calls, the backward's wrapper calls and device kernels, the patch
    embed's calls."""
    from focus_tpu_torch.ops import patch_embed as pe
    from focus_tpu_torch.ops import trajectory_block as tb

    return {"trajectory_block": tb.LAUNCHES,
            "trajectory_block_v3": tb.V3_LAUNCHES,
            "trajectory_block_v5": tb.V5_LAUNCHES,
            "trajectory_block_v6": tb.V6_LAUNCHES,
            "trajectory_block_v7": tb.V7_LAUNCHES,
            "trajectory_block_bwd": tb.BWD_LAUNCHES,
            "trajectory_block_bwd_device": tb.BWD_DEVICE_LAUNCHES,
            "patch_embed": pe.LAUNCHES}


def timed_train_steps(make, batch, core_kernel, per_call, tag):
    """``make``'s train step at ``batch``: TRAIN_WARMUP warm-up and
    TRAIN_ITERS timed steps with the launch counts reset just before them
    and each step's asserted (12 of ``core_kernel``'s wrapper and none of
    the other forward kernels, 12 backward wrapper calls of ``per_call``
    device kernels each, one patch embed), finite losses and gradients.
    Returns (report, launches, the stats' keys)."""
    from focus_tpu_torch.ops import patch_embed as pe
    from focus_tpu_torch.ops import trajectory_block as tb

    fn, (video, labels, boxes) = make(device=DEV, batch=batch, seed=0)
    first = [fn(video, labels, boxes)["loss"] for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tb.LAUNCHES = tb.V3_LAUNCHES = tb.V5_LAUNCHES = tb.V6_LAUNCHES = 0
    tb.V7_LAUNCHES = tb.BWD_LAUNCHES = tb.BWD_DEVICE_LAUNCHES = 0
    pe.LAUNCHES = 0
    depth = len(fn.model.blocks)  # 12: one core per block, both ways
    expect = {k: 0 for k in train_counts()}
    expect.update({core_kernel: depth, "trajectory_block_bwd": depth,
                   "trajectory_block_bwd_device": depth * per_call,
                   "patch_embed": 1})
    t0 = time.perf_counter()
    losses, keys = [], set()
    for _ in range(TRAIN_ITERS):
        before = train_counts()
        stats = fn(video, labels, boxes)
        losses.append(stats["loss"])
        keys |= set(stats)
        step = {k: v - before[k] for k, v in train_counts().items()}
        if step != expect:
            raise AssertionError(f"launches in one train step ({tag}): "
                                 f"{step}, expected {expect}")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = train_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [x.item() for x in first + losses]
    grads = grads_of(fn.model)
    nonfinite = [n for n, g in grads.items()
                 if not bool(torch.isfinite(g).all())]
    if not all(math.isfinite(x) for x in losses) or nonfinite:
        raise AssertionError(f"non-finite loss {losses} or gradients "
                             f"{nonfinite[:5]} ({tag})")
    del fn, grads, video, labels, boxes
    torch.cuda.empty_cache()
    report = {"batch": batch, "warmup_steps": TRAIN_WARMUP,
              "timed_steps": TRAIN_ITERS,
              "clips_per_sec": batch * TRAIN_ITERS / seconds,
              "ms_per_step": 1e3 * seconds / TRAIN_ITERS,
              "peak_memory_gb": peak_gb, "losses": losses,
              "launches": launches, "launches_per_step": expect}
    return report, launches, keys


def train_run(per_call, version):
    """The flagship train step through ``train_entry`` at batch 8 under
    FWD_VERSION ``version`` (``timed_train_steps``: 12 of the version's
    forward kernel a step), train clips/s, peak memory; then the kernel
    path against the float32 plain path at batch 2. Returns (report,
    launches, problems)."""
    from focus_tpu_torch.entry import train_entry
    from focus_tpu_torch.ops import trajectory_block as tb

    def run():
        steps, launches, _ = timed_train_steps(
            train_entry, 8, CORE_KERNELS[version], per_call,
            f"FWD_VERSION={version}")
        vs_plain, problems = train_vs_plain_path()
        report = {
            "fwd_version": version,
            "orvit_mf_ssv2_16x224_train_clips_per_sec_per_chip":
                steps.pop("clips_per_sec"),
            **steps, "vs_plain_path": vs_plain, "problems": problems}
        return report, launches, problems

    return run_version(tb, version, run)


def phase_train(smi, per_call):
    """The flagship train step (``train_run``) under FWD_VERSION 4, the
    default, and under 3 and 7 as sub-results. ``per_call`` is the device
    kernels one backward wrapper call launched in the kernel phase. Returns
    the launches of every run by version."""
    reports, launches, problems = {}, {}, []
    for version in (4, 3, 7):
        reports[version], launches[version], bad = train_run(per_call,
                                                             version)
        problems += [f"FWD_VERSION={version}: {p}" for p in bad]
    emit({"phase": "slice", "name": "train", "ok": not problems,
          "model": "ORViT-MF SSv2 16x224, D=768, 12 layers, 12 heads, ORViT "
                   "at [1,6,10], O=4, motion stream, 174 classes, bf16 "
                   "(float32 master weights); AdamW, base LR 5e-5, weight "
                   "decay 5e-2, steps_with_relative_lrs, 100 steps per "
                   "epoch, label-smoothing cross-entropy; init-scale "
                   "weights, seed 0",
          **reports[4], "fwd_version_3": reports[3],
          "fwd_version_7": reports[7], "gpu": smi})
    if problems:
        raise AssertionError(f"train slice: {problems[:5]}")
    return launches


def phase_hr336_train(smi, per_call):
    """The HR-336 EPIC-Kitchens train step (``hr_train_entry``, batch 4,
    EK_loss, FWD_VERSION 4) through ``timed_train_steps`` (12 kernel-1
    calls a step, 9 at N = 441 and 3 at 445, 12 backward calls of
    ``per_call`` device kernels, one patch embed), train clips/s, ms a
    step, peak memory, the loss the only stat; then the kernel path against
    the float32 plain path at batch 2 under ``train_vs_plain_path``'s
    rules. Returns the launches."""
    from focus_tpu_torch.entry import hr_train_entry
    from focus_tpu_torch.ops import trajectory_block as tb

    if tb.FWD_VERSION != 4:
        raise AssertionError(f"FWD_VERSION={tb.FWD_VERSION}, expected 4")
    steps, launches, keys = timed_train_steps(
        hr_train_entry, HR_BATCH, "trajectory_block", per_call, "HR-336")
    if keys != {"loss"}:
        raise AssertionError(f"HR-336 train stats {sorted(keys)}, expected "
                             "the loss alone")
    vs_plain, problems = train_vs_plain_path(hr_train_entry)
    emit({"phase": "slice", "name": "hr336_train", "ok": not problems,
          "model": "ORViT-MF-HR EK100 16x336 (configs/ORViT/"
                   "EK_ORVIT_MF_HR.yaml), D=768, 12 layers, 12 heads, ORViT "
                   "at [1,6,10], O=4, motion stream, verb [97] and noun "
                   "[300] heads, bf16 (float32 master weights); AdamW, base "
                   "LR 1e-5, ORViT LR 1e-4, weight decay 5e-2, "
                   "steps_with_relative_lrs, drop path 0.2, 100 steps per "
                   "epoch, EK_loss (verb + noun cross-entropy); init-scale "
                   "weights, seed 0; N = 441 keys a frame (445 in the ORViT "
                   "blocks)",
          "hr336_ek_b4_train_clips_per_sec": steps.pop("clips_per_sec"),
          **steps, "vs_plain_path": vs_plain, "problems": problems,
          "gpu": smi})
    if problems:
        raise AssertionError(f"HR-336 train slice: {problems[:5]}")
    return launches


# the multi-view test path (phase 13): a seeded in-script test split of each
# model at TEST.BATCH_SIZE 64, both yamls' own, 300 clips each (five
# batches, the last 44 clips and 20 pad rows): 10 EK videos x 10 views x 3
# crops and 100 SSv2 videos x 1 view x 3 crops. The package's log (the
# config dump, the meters' lines) goes to TEST_ENGINE_LOG, not to stdout.
TEST_ENGINE_DIR = os.path.join(REPO, "build", "test_engine")
TEST_ENGINE_LOG = os.path.join(REPO, "build", "test_engine.log")
TEST_ENGINE_BATCH = 64
TEST_ENGINE_ATOL = 1e-3  # the ensembled (summed) probabilities, direct loop


class TestClips:
    """A test split as the real datasets' test mode yields it: uint8
    frames of each view [T, crop, crop, 3], the label (EPIC-Kitchens' a
    dict of verb and noun), the clip index and {"orvit_bboxes": [T, O, 4]}
    (normalised cxcywh, empty boxes zeroed). Each view is a temporal window
    (``decoder.get_start_end_idx``, linspace sampling) and a spatial crop
    (``transform.uniform_crop``) of a seeded source video held in memory
    (2T frames, crop x 4/3 crop), its boxes carried through the crop and
    ``EKBoxes.prepare_boxes``; no file is read."""

    VIDEOS = 10
    EK = True

    def __init__(self, cfg, mode):
        assert mode == "test", mode
        self.cfg = cfg
        T, crop, O = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE, cfg.ORVIT.O
        self.views = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        rs = np.random.default_rng(cfg.RNG_SEED + 7)
        self.videos = rs.integers(0, 256, (self.VIDEOS, 2 * T, crop,
                                           crop * 4 // 3, 3), dtype=np.uint8)
        xy = rs.random((self.VIDEOS, 2 * T, O, 2)) * 0.6
        wh = rs.random((self.VIDEOS, 2 * T, O, 2)) * 0.4 - 0.05
        self.boxes = np.concatenate([xy, xy + wh], axis=-1)  # some empty
        self.labels = [(int(rs.integers(97)), int(rs.integers(300)))
                       for _ in range(self.VIDEOS)]

    def __len__(self):
        return self.VIDEOS * self.views

    def __getitem__(self, index):
        from focus_tpu_torch.datasets import decoder
        from focus_tpu_torch.datasets import transform as xf
        from focus_tpu_torch.datasets.epickitchens import EKBoxes

        cfg = self.cfg
        v, view = divmod(index, self.views)
        T = cfg.DATA.NUM_FRAMES
        start, end = decoder.get_start_end_idx(
            2 * T, T, view // cfg.TEST.NUM_SPATIAL_CROPS,
            cfg.TEST.NUM_ENSEMBLE_VIEWS)
        idx = np.clip(np.linspace(start, end, T), 0, 2 * T - 1).astype(
            np.int64)
        frames = self.videos[v][idx]
        h, w = frames.shape[1:3]
        boxes = self.boxes[v][idx] * np.array([w, h, w, h])
        frames, boxes = xf.uniform_crop(frames, cfg.DATA.TEST_CROP_SIZE,
                                        view % cfg.TEST.NUM_SPATIAL_CROPS,
                                        boxes=boxes)
        boxes = boxes / cfg.DATA.TEST_CROP_SIZE
        boxes = EKBoxes.prepare_boxes(boxes.transpose(1, 0, 2))
        verb, noun = self.labels[v]
        label = ({"verb": np.int32(verb), "noun": np.int32(noun)} if self.EK
                 else np.int32(verb % self.cfg.MODEL.NUM_CLASSES))
        return (np.ascontiguousarray(frames), label, np.int32(index),
                {"orvit_bboxes": boxes.astype(np.float32)})


class SSv2TestClips(TestClips):
    VIDEOS = 100
    EK = False


def register_test_clips():
    from focus_tpu_torch.datasets.build import DATASET_REGISTRY

    for name, cls in (("Chip_ek", TestClips), ("Chip_ssv2", SSv2TestClips)):
        if name not in DATASET_REGISTRY:
            DATASET_REGISTRY.register(cls, name=name)


def counted_test_run(run):
    """``run()`` (one pass of the test path) with the launch counts and the
    peak of allocated device memory reset just before it: (its result,
    launches, peak GB)."""
    from focus_tpu_torch.ops import patch_embed as pe
    from focus_tpu_torch.ops import trajectory_block as tb

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tb.LAUNCHES = tb.V3_LAUNCHES = tb.V5_LAUNCHES = tb.V6_LAUNCHES = 0
    tb.V7_LAUNCHES = pe.LAUNCHES = 0
    result = run()
    torch.cuda.synchronize()
    launches = {"trajectory_block": tb.LAUNCHES,
                "trajectory_block_v3": tb.V3_LAUNCHES,
                "trajectory_block_v7": tb.V7_LAUNCHES,
                "trajectory_block_v5": tb.V5_LAUNCHES,
                "trajectory_block_v6": tb.V6_LAUNCHES,
                "patch_embed": pe.LAUNCHES}
    return result, launches, torch.cuda.max_memory_allocated() / 1e9


def test_engine_case(cfg, first, tag):
    """Write a checkpoint of ``cfg``'s model built with seed RNG_SEED + 1
    (the tester builds RNG_SEED's weights), point TEST.CHECKPOINT_FILE_PATH
    at it, and run the test path twice: ``first()`` (returns the stats),
    then ``tester.run_test`` on ``cfg`` (returns the ``TestRun``), the
    launch counts reset just before each. Then check: 12 kernel-1 and 1
    kernel-2 launches a batch and none of the other versions' in each run;
    the same stats from both; every clip counted once; the stats the
    meter's keys; the whole checkpoint loaded, with tensors that differ
    from the ones the tester built; the ensembled probabilities against a
    direct loop over the same batches through ``EvalForward`` on the model
    that was saved (TEST_ENGINE_ATOL, and whether bit-equal), which shows
    the checkpoint's weights in use. Reports the second run's loop: clips/s
    (host clock, loader included), the share of it spent waiting for a
    batch (with and without the first batch's wait) and its peak of
    allocated device memory; and the forward's clips/s alone on the same
    batches."""
    from focus_tpu_torch.datasets.build import build_dataset
    from focus_tpu_torch.engine import tester
    from focus_tpu_torch.entry import EvalForward
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.ops.preprocess import device_normalize
    from focus_tpu_torch.utils import checkpoint as cu

    seed = cfg.RNG_SEED + 1
    written = build_model(cfg, DEV, seed=seed)
    path = cu.save_checkpoint(os.path.join(TEST_ENGINE_DIR, tag), written, 0,
                              cfg, name=f"seed{seed}")
    cfg.TEST.CHECKPOINT_FILE_PATH = path
    resident_gb = torch.cuda.memory_allocated() / 1e9
    stats, first_launches, first_peak = counted_test_run(first)
    run, launches, peak_gb = counted_test_run(
        lambda: tester.run_test(cfg, device=DEV))
    meter, report = run.meter, run.checkpoint
    batches, clips = run.batches, run.clips
    expect = {k: 0 for k in launches}
    expect["trajectory_block"] = len(written.blocks) * batches
    expect["patch_embed"] = batches
    problems = []
    for name, got in (("first", first_launches), ("second", launches)):
        if got != expect:
            problems.append(f"{name} run's launches {got}, expected {expect}")
    if run.stats != stats:
        problems.append("the second run's stats differ from the first's")
    ek = isinstance(meter, tester.EPICTestMeter)
    num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    counted_once = bool((meter.clip_count == num_clips).all()
                        and meter.seen_clips.sum() == clips)
    if not counted_once:
        problems.append(f"clip counts {meter.clip_count.tolist()}")
    keys = ({f"{h}_top{k}_acc" for h in ("verb", "noun", "action")
             for k in (1, 5)} if ek else {"top1_acc", "top5_acc"})
    if set(stats) != keys | {"split"}:
        problems.append(f"stats keys {sorted(stats)}")

    state = written.state_dict()
    initial = build_model(cfg, DEV)  # the weights the tester built
    changed = sum(not torch.equal(v, state[k])
                  for k, v in initial.state_dict().items())
    del initial
    if not (report["path"] == path and not report["missing"]
            and len(report["loaded"]) == len(state) and changed):
        problems.append("the checkpoint was not loaded whole, or changes "
                        "nothing")

    # the same batches (the loader's order, pad rows included) straight
    # through EvalForward on the saved model, the forward timed alone
    dataset = build_dataset(cfg.TEST.DATASET, cfg, "test")
    forward = EvalForward(written)
    bs, n = cfg.TEST.BATCH_SIZE, len(dataset)
    ensembles = ((meter.verb_preds, meter.noun_preds) if ek
                 else (meter.video_preds,))
    sums = [np.zeros_like(p) for p in ensembles]
    seconds = 0.0
    for start in range(0, n, bs):
        idx = list(range(start, min(start + bs, n)))
        real = len(idx)
        idx += idx[: bs - real]
        items = [dataset[i] for i in idx]
        video = torch.from_numpy(np.stack([it[0] for it in items])).to(DEV)
        boxes = torch.from_numpy(np.stack([it[3]["orvit_bboxes"]
                                           for it in items])).to(DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward(device_normalize(video, cfg), boxes)
        torch.cuda.synchronize()
        seconds += time.perf_counter() - t0
        heads = (out[1]["verb"], out[1]["noun"]) if ek else (out,)
        for acc, probs in zip(sums, heads):
            probs = probs.float().cpu().numpy().astype(np.float64)
            for row, i in enumerate(idx[:real]):
                acc[i // num_clips] += probs[row]
    max_abs = max(float(np.abs(a - b).max()) for a, b in zip(ensembles, sums))
    bit_equal = all(np.array_equal(a, b) for a, b in zip(ensembles, sums))
    if not max_abs <= TEST_ENGINE_ATOL:
        problems.append(f"ensembled probabilities {max_abs} from the loop")
    result = {"ok": not problems, "problems": problems, "stats": stats,
              "videos": len(meter.clip_count), "clips": clips,
              "batch_size": bs, "batches": batches,
              "pad_rows": batches * bs - clips,
              "every_clip_counted_once": counted_once,
              "checkpoint": {"path": os.path.relpath(path, REPO),
                             "loaded": len(report["loaded"]),
                             "missing": len(report["missing"]),
                             "unused": len(report["unused"]),
                             "tensors_changed_by_the_load": changed},
              "launches": launches, "launches_first_run": first_launches,
              "launches_per_batch": {k: v / batches
                                     for k, v in launches.items()},
              "vs_direct_loop": {"max_abs_summed_prob": max_abs,
                                 "atol": TEST_ENGINE_ATOL,
                                 "bit_equal": bit_equal},
              "test_loop_clips_per_sec": clips / run.seconds,
              "loop": {"seconds": run.seconds,
                       "wait_seconds": run.wait_seconds,
                       "first_wait_seconds": run.first_wait_seconds,
                       "wait_share": run.wait_seconds / run.seconds,
                       "wait_share_after_the_first_batch":
                           (run.wait_seconds - run.first_wait_seconds)
                           / run.seconds,
                       "peak_memory_gb": peak_gb,
                       "peak_memory_gb_first_run": first_peak,
                       "allocated_before_gb": resident_gb,
                       "allocated_before_note": "the saved model, kept for "
                                                "the direct loop"},
              "forward_clips_per_sec": clips / seconds,
              "forward_seconds": seconds}
    del written, forward, run, meter
    torch.cuda.empty_cache()
    return result


def phase_test_engine(smi):
    """The multi-view test path end to end on the card (phase 13), on two
    in-script test splits (``TestClips``) registered in the port's
    DATASET_REGISTRY, each 300 clips at TEST.BATCH_SIZE 64: ORViT-MF-HR
    EK100 16x336 on ``configs/ORViT/EK_ORVIT_MF_HR.yaml`` (the model of
    ``entry.hr_cfg``: full width and depth), first through
    ``tools.run_net.main``; then the flagship SSv2 16x224
    (``entry.flagship_cfg``, the SSv2 yaml's test batch and workers), first
    through ``engine.tester.test``. Each is held by ``test_engine_case``;
    the package's log goes to TEST_ENGINE_LOG."""
    import contextlib

    from focus_tpu_torch.config.defaults import assert_and_infer_cfg
    from focus_tpu_torch.engine import tester
    from focus_tpu_torch.entry import flagship_cfg
    from focus_tpu_torch.tools import run_net
    from focus_tpu_torch.utils import logging as port_logging
    from focus_tpu_torch.utils.parser import load_config, parse_args

    register_test_clips()
    shutil.rmtree(TEST_ENGINE_DIR, ignore_errors=True)
    os.makedirs(TEST_ENGINE_DIR)
    yaml = os.path.join(REPO, "configs", "ORViT", "EK_ORVIT_MF_HR.yaml")
    argv = ["--device", DEV, "--cfg", yaml, "--exp_name", "chip_smoke",
            "TRAIN.ENABLE", "False", "TEST.EVAL_TASK", "ar",
            "TEST.DATASET", "chip_ek",
            "OUTPUT_DIR", os.path.join(TEST_ENGINE_DIR, "hr336")]
    hr_cfg = assert_and_infer_cfg(load_config(parse_args(argv)))
    assert hr_cfg.TEST.BATCH_SIZE == TEST_ENGINE_BATCH, hr_cfg.TEST.BATCH_SIZE

    cfg = flagship_cfg()
    cfg.MODEL.ARCH = "slow"
    cfg.TEST.DATASET = "chip_ssv2"
    cfg.DATA.TEST_CROP_SIZE = 224
    cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS = 1, 3
    cfg.TEST.BATCH_SIZE = TEST_ENGINE_BATCH  # SSv2_ORViT-MF_224_16x4.yaml's
    cfg.DATA_LOADER.NUM_WORKERS = 6  # as the SSv2 yaml
    cfg.OUTPUT_DIR = os.path.join(TEST_ENGINE_DIR, "flagship")

    result = {"phase": "test_engine", "gpu": smi}
    try:
        with open(TEST_ENGINE_LOG, "w") as log, \
                contextlib.redirect_stdout(log):
            result["hr336_ek"] = {
                "model": "ORViT-MF-HR EK100 16x336 (configs/ORViT/"
                         "EK_ORVIT_MF_HR.yaml, first run through "
                         "tools.run_net), D=768, 12 layers, 12 heads, bf16; "
                         "10 videos x 10 views x 3 crops",
                **test_engine_case(hr_cfg, lambda: run_net.main(
                    argv + ["TEST.CHECKPOINT_FILE_PATH",
                            hr_cfg.TEST.CHECKPOINT_FILE_PATH]), "hr336")}
            result["flagship_ssv2"] = {
                "model": "ORViT-MF SSv2 16x224 (entry.flagship_cfg, first "
                         "run through engine.tester.test), D=768, 12 "
                         "layers, 12 heads, bf16; 100 videos x 1 view x 3 "
                         "crops",
                **test_engine_case(
                    cfg, lambda: tester.test(cfg, device=DEV), "flagship")}
    finally:
        port_logging.close_logging()
        shutil.rmtree(TEST_ENGINE_DIR, ignore_errors=True)
    result["ok"] = result["hr336_ek"]["ok"] and result["flagship_ssv2"]["ok"]
    emit(result)
    if not result["ok"]:
        raise AssertionError("test engine phase failed")


def main():
    if not torch.cuda.is_available():
        emit({"ok": False, "error": "CUDA is not available"})
        return 1
    try:
        from focus_tpu_torch.entry import steve_entry
    except ImportError as e:
        emit({"ok": False, "error": f"run from the repository root ({e})"})
        return 1
    smi = nvidia_smi_line()
    emit({"phase": "env", "ok": True, "gpu": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count()})
    phase_build()
    traj = phase_trajectory_kernel()
    bwd = phase_trajectory_backward()
    space = phase_space_stage()
    v3, v7, v5, v6 = phase_variants()
    patch = phase_patch_kernel()
    phase_fixture()
    phase_steve_fixtures()
    launches = phase_slice(smi)
    traj["launches"] = launches["trajectory_block"]
    patch["launches"] = launches["patch_embed"]
    hr = phase_hr336(smi)
    traj["hr336"] = {k: v for k, v in hr.items() if k != "launches"}
    traj["launches_hr336"] = hr["launches"]["trajectory_block"]
    patch["launches_hr336"] = hr["launches"]["patch_embed"]
    traj["launches_note"] = patch["launches_note"] = (
        f"over {SLICE_ITERS} flagship forwards; launches_hr336 over "
        f"{SLICE_ITERS} HR-336 forwards at batch {HR_BATCH} (kernel 1 at N = "
        "441 and 445, hr336: its times there at B = 4); launches_train over "
        f"{TRAIN_ITERS} flagship train steps; launches_hr336_train over "
        f"{TRAIN_ITERS} HR-336 train steps at batch {HR_BATCH}; "
        "launches_serving over "
        f"{SLICE_ITERS} forwards of each of the {len(VARIANTS)} models of the "
        "serving matrix")
    versions = phase_flagship_fwd_versions(smi)
    for row, version in ((v3, 3), (v7, 7), (v5, 5), (v6, 6)):
        row["launches"] = versions[version]
        row["launches_note"] = (
            f"over {SLICE_ITERS} flagship forwards through entry() under "
            f"FWD_VERSION={version} (12 per forward, each "
            f"{row['device_launches_per_call']} device kernels; kernel 1's "
            "wrapper called 0 times in them)")
    space["launches"], space["launches_hr336"] = phase_learned_v(smi)
    space["launches_note"] = (
        f"over {SLICE_ITERS} eval forwards of the 12-block learned-v stack "
        f"(12 per stack); launches_hr336 over {SLICE_ITERS} eval forwards of "
        f"the stack at the 336 crop, batch {HR_BATCH} (N = 441, the chunked "
        "form; hr336: its times at BH = 48)")
    trains = phase_train(smi, bwd["device_launches_per_call"])
    train = trains[4]
    traj["launches_train"] = train["trajectory_block"]
    for row, version in ((v3, 3), (v7, 7)):
        row["launches_train"] = trains[version][CORE_KERNELS[version]]
        row["launches_note"] += (
            f"; launches_train over {TRAIN_ITERS} flagship train steps under "
            f"FWD_VERSION={version} (12 per step; kernel 1 launched 0 times "
            "in them)")
    patch["launches_train"] = train["patch_embed"]
    bwd["launches"] = train["trajectory_block_bwd"]
    bwd["device_launches"] = train["trajectory_block_bwd_device"]
    bwd["launches_note"] = (
        f"wrapper calls over {TRAIN_ITERS} flagship train steps; "
        "device_launches are the kernels those calls launched; "
        "launches_fwd_version_3 and _7 over as many steps under "
        "FWD_VERSION=3 and 7")
    bwd["launches_fwd_version_3"] = trains[3]["trajectory_block_bwd"]
    bwd["launches_fwd_version_7"] = trains[7]["trajectory_block_bwd"]
    hr_train = phase_hr336_train(smi, bwd["device_launches_per_call"])
    bwd["launches_hr336_train"] = hr_train["trajectory_block_bwd"]
    bwd["device_launches_hr336_train"] = hr_train["trajectory_block_bwd_device"]
    traj["launches_hr336_train"] = hr_train["trajectory_block"]
    patch["launches_hr336_train"] = hr_train["patch_embed"]
    bwd["launches_note"] += (
        f"; launches_hr336_train over {TRAIN_ITERS} HR-336 train steps at "
        f"batch {HR_BATCH} (N = 441 and 445, the dq kernel's chunked form; "
        "hr336: its times there)")
    hr_versions = phase_hr336_fwd_versions(
        smi, bwd["device_launches_per_call"])
    for row, version in ((v3, 3), (v7, 7), (v5, 5), (v6, 6)):
        row["launches_hr336"] = hr_versions[version]["hr336"]
        row["launches_hr336_train"] = hr_versions[version]["hr336_train"]
        row["launches_note"] += (
            f"; launches_hr336 over {SLICE_ITERS} HR-336 forwards at batch "
            f"{HR_BATCH} under FWD_VERSION={version} (12 per forward, nine "
            "at N = 441 and three at 445, the chunked form; hr336: its "
            "times at B = 4); launches_hr336_train in one HR-336 train step "
            f"at batch 2 under FWD_VERSION={version} (12)")
    steve_model = steve_entry(device=DEV, batch=8)[0].model
    ar = phase_ar_decode(steve_model)
    arq = phase_ar_decode_w8a8(steve_model)
    del steve_model
    torch.cuda.empty_cache()
    counts = phase_steve(smi, ar["device_launches_per_step"])
    ar["launches"] = counts["wrapper"]
    ar["device_launches"] = counts["device"]
    ar["launches_note"] = (
        f"decode steps of {STEVE_ITERS} rollouts of 32 rows through "
        "steve_entry, each rollout one replay of its captured graph; "
        "device_launches are the kernels those steps launched (counted at "
        "the capture), every one with the PDL attribute")
    serving = phase_serving(smi)
    traj["launches_serving"] = serving["trajectory_block"]
    patch["launches_serving"] = serving["patch_embed"]
    counts = phase_steve_w8a8(smi, arq["device_launches_per_step"])
    arq["launches"] = counts["wrapper"]
    arq["device_launches"] = counts["device"]
    arq["launches_note"] = (
        f"decode steps of {STEVE_ITERS} rollouts of 32 rows through "
        "steve_entry(int8=True), each rollout one replay of its captured "
        "graph; device_launches are the kernels those steps launched "
        "(counted at the capture), every one with the PDL attribute")
    phase_test_engine(smi)
    emit({"kernels": [traj, patch, bwd, ar, arq, space, v5, v6, v3, v7]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as e:  # report, then fail: no phase failure exits 0
        emit({"ok": False, "error": f"{type(e).__name__}: {e}"})
        raise
    sys.exit(code)
