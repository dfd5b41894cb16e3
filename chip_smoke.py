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
     waiting for batches;
 14. the supervised train loop (``tools.run_net`` ->
     ``engine.trainer.train``) on in-script splits: HR-336 EK and the
     flagship SSv2 at their yamls' batches, held against a direct step
     loop, a resumed run and a preempted one;
 15. STEVE training and its segmentation eval (``tools.run_net`` ->
     ``engine.slot_trainer``): the MOVi-E recipe (configs/movi_e/base.yaml,
     res18, 64 px, 15 slots, decoder D=192 x 4 x 4, vocabulary 4096, bf16)
     on synthetic two-frame clips, 2 epochs of 4 steps at batch 16 (finite
     losses, best_model.pt, checkpoint.pt.tar and the epoch checkpoints,
     every val and test clip once, mBO in [0, 100], FG-ARI in [-100,
     100]), then
     best_model.pt in a fresh model rolled out at 32 rows through kernel 9
     (counted; its graph recaptured for loaded weights; ids and logits
     against the plain path); one step at batch 2 in float32 on the card
     against the CPU (loss 1e-4, each gradient 1e-3 relative L2); the step
     at batch 16 timed by CUDA events on a fixed batch, the loss falling,
     the device's busy share under torch.profiler, peak memory;
 16. the ResNet video family (no hand-written kernel: F.conv3d, BatchNorm in
     float32): the four conv-family fixtures of the executed reference in
     float32 (5e-5); SlowFast 8x8 R50 (configs/Kinetics/SLOWFAST_8x8_R50.yaml,
     full width, bf16) at batch 8, its eval forward at the 256 test crop
     (clips/s in channels_last_3d and NCDHW, peak memory, probabilities
     against float32) and its SGD step at the 224 crop (train clips/s, peak
     memory, the busy share and the device time by kind under
     torch.profiler; at batch 2 in float32 the card against the CPU: loss,
     each gradient, the running statistics); ``tools.run_net`` on in-script
     Kinetics splits (2 epochs with precise BN, validation and checkpoints,
     then the test path from the last checkpoint, 4 videos x 3 crops, held
     against a direct loop); X3D-M's forward and step against float32 and
     its depthwise convolutions' times;
 17. MViT (no hand-written kernel: ``F.conv3d`` stem and pooling, the
     attention two matmuls): the reference's mvit_full and
     multiscale_attention fixtures in float32 (1e-4, 3e-5); MViT-B 16x4
     (configs/Kinetics/MVIT_B_16x4_CONV.yaml, full width and depth, bf16)
     at batch 8, its eval forward at the 224 crop (clips/s, peak memory,
     the busy share, probabilities against float32, the W8A8 model within
     0.05) and its AdamW step under the yaml's mixup (train clips/s, peak
     memory, the busy share; at batch 2 in float32 the card against the
     CPU: loss, each gradient); ``tools.run_net`` on in-script Kinetics
     splits (2 epochs, validation, the test path from the checkpoint,
     against a direct loop); every MViT yaml built and run at its own
     width; ORViT at MViT's head dim 96 refused before any launch;
 18. the remaining datasets behind the card (host numpy, no hand-written
     kernel; only the three file readers substituted, ``InScriptReaders``,
     since the checkout holds no such data files): Kinetics
     (configs/Kinetics/MVIT_B_16x4_CONV.yaml: 4 videos x 2 repeated
     augmentations a step, RandAugment, random erasing, mixup), Charades
     (configs/Charades/SLOWFAST_16x8_R50.yaml: 64 frames, 157 multi-hot
     classes, precise BN, mAP, 10 x 3 views under max) and ImageNet
     (configs/ImageNet/MVIT_B_16_CONV.yaml, batch 32) through
     ``tools.train_net`` then ``tools.test_net`` at full width in bf16:
     every step's batch, the loop against a direct step loop on the same
     batches (the first loss bit-equal, losses 1e-3, parameters 1e-4, the
     update 5e-2 relative L2), validation's stats, every test clip once, the ensembles
     against a direct loop (1e-3); each loop's clips/s, the step's alone,
     the wait share, the host's ms per clip of each dataset's
     ``__getitem__`` without its read, peak memory.
 19. the Switch-MoE Motionformer (configs/TPU/SSv2_MF_224_16x4_pp_moe.yaml
     with TPU.MESH.PIPE 1 TPU.MESH.EXPERT 1 NUM_GPUS 1: every expert on the
     card; D=768, 12 blocks of 4 top-1 experts at capacity 1.25, bf16)
     through kernels 1, 2 and 7: its eval forward and AdamW step at batch 8
     (clips/s, peak memory, tokens dropped and expert loads by layer, the
     busy share, one MoE layer's routing / dispatch and combine / expert
     products split; 12 + 1 launches a forward, 12 + 12 + 1 a step); at
     batch 2 in float32 the card against the CPU (routing of every layer,
     loss, moe_aux, gradients); ``tools.train_net`` and ``tools.test_net``
     on in-script SSv2 splits against a direct loop; the yaml's own mesh
     refused before any launch;
 20. AVA detection (no hand-written kernel; only the frame reads
     substituted, ``AvaFrames``): SlowFast 32x2 R50
     (configs/AVA/SLOWFAST_32x2_R50_SHORT.yaml, 80 classes, batch 8, bf16)
     through ``tools.train_net`` then ``tools.test_net`` over an in-script
     AVA tree (frame mAP under the official protocol, every test keyframe
     once, the pad rows dropped, the loop against a direct loop, clips/s,
     the wait share, the host's ms per clip); MViT-B 16x4's AVA forward and
     step; the Caffe2 RoIAlign (``DETECTION.ALIGNED False``) against
     float32.
 21. data parallelism and multigrid: the flagship train loop (mixup on)
     through ``tools.run_net.launch_job`` with ``init_distributed`` at world
     1 on NCCL (the gradient all-reduce, mixup's partner all-gather, the
     eval gathers through NCCL; 12 + 12 + 1 launches a step), then two
     ranks spawned on the one card (gloo: NCCL refuses two ranks on one
     device) at global batch 8 under TPU.GRAD_ACCUM 2 against one process
     (losses 1e-3, the update 5e-2, the test ensembles 1e-3, every val and
     test clip once), the step's ms and the all-reduce's share by CUDA
     events; configs/Kinetics/SLOWFAST_8x8_R50_stepwise_multigrid.yaml on
     one process (reads substituted as in phase 18, cut to 7 epochs) through
     every long-cycle shape and short-cycle phase: the LR of every step
     against the rewritten schedule, a line per shape.
 22. tensor and sequence parallelism (``phase_mesh``): kernels 1 and 7
     over windows of query frames, remat, the dp x sp x tp yaml as 8 gloo
     ranks, HR-336 under SEQ 2.
 23. pipeline and expert parallelism (``phase_pipe_expert``): the pp_moe
     yaml as 8 gloo ranks (DATA 2 x PIPE 2 x EXPERT 2) through
     ``tools.run_net`` against the one-process pipelined model that plays
     both data ranks (losses and moe_aux 1e-3, the update 5e-2, ensembles
     1e-3, every clip once, the checkpoint bit for bit, each rank's bytes
     and launches), the flagship under PIPE 2 on two ranks, and the
     pipelined eval against the plain one (1e-3).
Every phase line carries ``wall_seconds``, the seconds since the previous
phase line. Then the kernel table, the card's nvidia-smi line, and the
result line.
The script imports nothing of JAX.
"""

import contextlib
import functools
import hashlib
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


# the host clock at the last phase line
_PHASE_CLOCK = [time.perf_counter()]


def emit(obj):
    """Print ``obj`` as one JSON line; a phase's line carries its wall
    seconds, since the previous phase line (``wall_seconds``)."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "wall_seconds": now - _PHASE_CLOCK[0]}
        _PHASE_CLOCK[0] = now
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
        def alone(names):
            return (len(names) == 1
                    and "space_stage_chunked_kernel" in names[0])

        names = device_kernels(lambda: ta.space_stage(q, k, v, F, scale),
                               alone)
        if not alone(names):
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
        call = functools.partial(launch, *args[:6], scale, heads)
        expect = [r"space_stage_chunked_kernel<", r"traj_gemm_kernel",
                  r"traj_stage2_kernel<"]
    else:
        call = functools.partial(tb._launch_variant, version, *args[:6],
                                 scale, heads)
        expect = [r"traj_gemm_kernel", r"own_frame_kernel<\d+, 2>",
                  r"traj_gemm_kernel", r"k2v_pass_kernel<\d+, [^,]+, 2>"]

    def as_expected(names):
        return len(names) == len(expect) and all(
            re.search(e, n) for e, n in zip(expect, names))

    names = device_kernels(call, as_expected)
    if not as_expected(names):
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


PROFILE_ATTEMPTS = 5
# the kernel of torch.cuda._sleep, which opens every trace of
# device_kernels
PROFILE_MARKER = "spin_kernel"


def device_kernels(fn, complete=None):
    """Names of the device kernels one call of ``fn`` launches, as
    torch.profiler traces them on the card, in the order they started.
    The profiler now and then leaves kernels out of a trace: all of them,
    or the first one it would hold (v3's chunked stage 1 once, with its
    GEMM and stage 2 traced). So each trace opens with a marker kernel
    (``torch.cuda._sleep``) and a synchronisation, and the names are those
    that started after the marker (all of them where the marker itself
    was left out). A trace that holds none, or whose names ``complete``
    refuses, is taken again, up to PROFILE_ATTEMPTS traces; the callers
    check the names of the last trace taken."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        marks = [i for i, n in enumerate(names) if PROFILE_MARKER in n]
        if marks:
            names = names[marks[-1] + 1:]
        if names and (complete is None or complete(names)):
            break
    return names


def check_kernel_1_launches(tb, args, scale, heads, tag):
    """One call of kernel 1's wrapper launches its three device kernels
    (at N > 256 the chunked stage 1 first); returns their names."""
    stage1 = ("space_stage_chunked_kernel" if args[1].shape[2] > 256
              else "space_stage_kernel")

    def as_expected(names):
        return (len(names) == KERNEL_1_DEVICE_LAUNCHES_PER_CALL
                and stage1 in names[0])

    names = device_kernels(lambda: tb._launch(*args[:6], scale, heads),
                           as_expected)
    if not as_expected(names):
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


# the supervised train loop (phase 14): in-script train / val splits of each
# model, run through the loop at the yamls' batch, then held against a direct
# step loop, a direct validation loop, a resumed run and a preempted one. The
# package's log goes to TRAIN_ENGINE_LOG, not to stdout.
TRAIN_ENGINE_DIR = os.path.join(REPO, "build", "train_engine")
TRAIN_ENGINE_LOG = os.path.join(REPO, "build", "train_engine.log")
TRAIN_ENGINE_VAL = 40  # val clips of each model: one padded batch
HR_TRAIN_STEPS = 4  # steps an epoch at the EK yaml's TRAIN.BATCH_SIZE 16
FLAGSHIP_TRAIN_BATCH = 48  # SSv2_ORViT-MF_224_16x4.yaml's
FLAGSHIP_GRAD_ACCUM = 2
FLAGSHIP_TRAIN_STEPS = 2
# the loop against the direct step loop over the same batches from the same
# weights and generator seed, where the two are not bit-equal (atomic sums
# in a backward reorder float32 additions): each step's loss within this
# share of it, and the parameters after the last step within this share of
# their norm (relative L2)
TRAIN_LOOP_LOSS_REL = 1e-3
TRAIN_LOOP_PARAM_REL = 1e-4
VAL_STATS_ATOL = 1e-9  # percentages: the meter's weighted means, float64


class TrainClips:
    """A train or val split as the real datasets' train mode yields it:
    uint8 frames [T, crop, crop, 3], the label (EPIC-Kitchens' a dict of
    verb and noun), the clip index and {"orvit_bboxes": [T, O, 4]}
    (normalised cxcywh, empty boxes zeroed), T boxes a clip as the datasets
    give them. A clip is a random temporal window and a random crop
    (``transform.random_crop``, the boxes carried through) of one of
    SOURCES seeded source videos in memory (2T frames, 9/8 x 5/4 of the
    crop), drawn from a generator seeded by the clip index and, for the
    train split, the epoch (``epoch``, which ``epoch_seeded_splits`` sets
    at each shuffle): two runs see the same clips; no file is read."""

    SOURCES = 8

    def __init__(self, cfg, mode, clips, ek):
        self.cfg, self.mode, self.clips, self.ek = cfg, mode, clips, ek
        self.epoch = 0
        T, crop, O = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE, cfg.ORVIT.O
        rs = np.random.default_rng(cfg.RNG_SEED + 11)
        self.videos = rs.integers(
            0, 256, (self.SOURCES, 2 * T, crop * 9 // 8, crop * 5 // 4, 3),
            dtype=np.uint8)
        xy = rs.random((self.SOURCES, 2 * T, O, 2)) * 0.6
        wh = rs.random((self.SOURCES, 2 * T, O, 2)) * 0.4 - 0.05
        self.boxes = np.concatenate([xy, xy + wh], axis=-1)  # some empty

    def __len__(self):
        return self.clips

    def __getitem__(self, index):
        from focus_tpu_torch.datasets import transform as xf
        from focus_tpu_torch.datasets.epickitchens import EKBoxes

        cfg = self.cfg
        T, crop = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
        seed = [cfg.RNG_SEED, index] + (
            [self.epoch] if self.mode == "train" else [])
        rng = np.random.RandomState(seed)
        v = index % self.SOURCES
        start = rng.randint(0, T + 1)
        frames = self.videos[v, start:start + T]
        h, w = frames.shape[1:3]
        boxes = self.boxes[v, start:start + T] * np.array([w, h, w, h])
        frames, boxes = xf.random_crop(frames, crop, rng, boxes=boxes)
        boxes = EKBoxes.prepare_boxes((boxes / crop).transpose(1, 0, 2))
        label = ({"verb": np.int32(index * 7 % 97),
                  "noun": np.int32(index * 13 % 300)} if self.ek
                 else np.int32(index * 7 % cfg.MODEL.NUM_CLASSES))
        return (np.ascontiguousarray(frames), label, np.int32(index),
                {"orvit_bboxes": boxes.astype(np.float32)})


class EKTestClips(TestClips):
    VIDEOS = 2  # x 10 views x 3 crops: 60 clips


def chip_splits(ek, train_clips, val_clips):
    """The dataset factory of one model's in-script splits: TrainClips for
    train and val, EKTestClips for test."""
    def make(cfg, mode):
        if mode == "test":
            return EKTestClips(cfg, mode)
        return TrainClips(cfg, mode, train_clips if mode == "train"
                          else val_clips, ek)

    return make


@contextlib.contextmanager
def registered_splits(splits):
    """``splits`` ({registry name: factory}) in the port's
    DATASET_REGISTRY, over any class of the same name (the trainer and the
    tester key EPIC-Kitchens on the name); the registry restored after."""
    import focus_tpu_torch.datasets.epickitchens  # noqa: F401 (registration)
    from focus_tpu_torch.datasets.build import DATASET_REGISTRY

    table = DATASET_REGISTRY._map
    saved = {name: table.get(name) for name in splits}
    table.update(splits)
    try:
        yield
    finally:
        for name, obj in saved.items():
            if obj is None:
                table.pop(name, None)
            else:
                table[name] = obj


@contextlib.contextmanager
def epoch_seeded_splits():
    """The train loop's ``shuffle_dataset`` also tells an in-script split
    the epoch it draws."""
    from focus_tpu_torch.datasets import loader

    shuffle = loader.shuffle_dataset

    def shuffle_dataset(train_loader, cur_epoch):
        train_loader.dataset.epoch = cur_epoch
        shuffle(train_loader, cur_epoch)

    loader.shuffle_dataset = shuffle_dataset
    try:
        yield
    finally:
        loader.shuffle_dataset = shuffle


def reset_counts():
    from focus_tpu_torch.ops import patch_embed as pe
    from focus_tpu_torch.ops import trajectory_block as tb

    tb.LAUNCHES = tb.V3_LAUNCHES = tb.V5_LAUNCHES = tb.V6_LAUNCHES = 0
    tb.V7_LAUNCHES = tb.BWD_LAUNCHES = tb.BWD_DEVICE_LAUNCHES = 0
    pe.LAUNCHES = 0


def counted(run):
    """``run()`` with every launch count and the peak of allocated device
    memory reset just before it: (its result, launches, peak GB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    result = run()
    torch.cuda.synchronize()
    return result, train_counts(), torch.cuda.max_memory_allocated() / 1e9


@contextlib.contextmanager
def captured_engine(runs):
    """``trainer.train`` and ``tester.test``, as ``tools.run_net`` calls
    them, each ``counted``: the TrainRun / TestRun, its launches and peak
    memory appended to ``runs["train"]`` / ``runs["test"]``."""
    from focus_tpu_torch.engine import tester, trainer

    train, test = trainer.train, tester.test

    def counted_train(cfg, device="cuda"):
        runs["train"].append(counted(lambda: trainer.run_train(cfg, device)))
        return runs["train"][-1][0].state

    def counted_test(cfg, device="cuda"):
        runs["test"].append(counted(lambda: tester.run_test(cfg, device)))
        return runs["test"][-1][0].stats

    trainer.train, tester.test = counted_train, counted_test
    try:
        yield
    finally:
        trainer.train, tester.test = train, test


def host_params(model):
    return {k: v.detach().float().cpu() for k, v in model.state_dict().items()}


def params_rel_l2(a, b):
    num = math.sqrt(sum(float((a[k].double() - b[k].double()).pow(2).sum())
                        for k in a))
    den = math.sqrt(sum(float(b[k].double().pow(2).sum()) for k in b))
    return num / den


def direct_train_loop(cfg, init_path, epochs):
    """``make_supervised_train_step`` over the train split's batches of
    ``epochs`` epochs (the loader's order and clips), from the weights at
    ``init_path`` and a state seeded as the loop seeds it; each step timed
    alone (synchronized). Returns (losses by epoch, host parameters,
    seconds, clips)."""
    from focus_tpu_torch.datasets import loader as data_loader
    from focus_tpu_torch.engine import trainer
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.models.losses import get_loss_func
    from focus_tpu_torch.utils import checkpoint as cu

    train_loader = data_loader.construct_loader(cfg, "train", DEV)
    model = build_model(cfg, DEV)
    state = trainer.build_supervised_state(cfg, model, len(train_loader))
    cu.load_checkpoint(init_path, model, cfg)
    step = trainer.make_supervised_train_step(model, cfg, get_loss_func(cfg))
    model.train()
    losses, seconds, clips = [], 0.0, 0
    for epoch in range(epochs):
        train_loader.dataset.epoch = epoch
        data_loader.shuffle_dataset(train_loader, epoch)
        losses.append([])
        for batch in train_loader:
            video, labels, metadata = trainer.split_batch(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, stats = step(state, video, labels, metadata)
            torch.cuda.synchronize()
            seconds += time.perf_counter() - t0
            losses[-1].append(stats["loss"].item())
            clips += video.shape[0]
    params = host_params(model)
    del model, state, step, train_loader
    torch.cuda.empty_cache()
    return losses, params, seconds, clips


def direct_val(cfg, checkpoint, ek):
    """The val split's clips in the loader's order and batches (the last
    filled from its own rows, as ``pad_last`` fills it), through
    ``EvalForward`` on a model loaded from ``checkpoint``; the pad rows
    dropped; the val meter's means computed over all clips at once:
    top-1 / top-5 errors, or EPIC-Kitchens' verb, noun and action top-1 /
    top-5 accuracies."""
    from focus_tpu_torch.datasets.build import build_dataset
    from focus_tpu_torch.entry import EvalForward
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.ops.preprocess import device_normalize
    from focus_tpu_torch.utils import checkpoint as cu
    from focus_tpu_torch.utils import metrics

    dataset = build_dataset(cfg.TRAIN.DATASET, cfg, "val")
    model = build_model(cfg, DEV)
    cu.load_checkpoint(checkpoint, model, cfg)
    forward = EvalForward(model)
    bs, n = cfg.TRAIN.BATCH_SIZE, len(dataset)
    preds, labels = [], []
    for start in range(0, n, bs):
        idx = list(range(start, min(start + bs, n)))
        real = len(idx)
        idx += idx[: bs - real]
        items = [dataset[i] for i in idx]
        video = torch.from_numpy(np.stack([it[0] for it in items])).to(DEV)
        boxes = torch.from_numpy(np.stack([it[3]["orvit_bboxes"]
                                           for it in items])).to(DEV)
        out = forward(device_normalize(video, cfg), boxes)
        heads = (out[1]["verb"], out[1]["noun"]) if ek else (out,)
        preds.append([h[:real].float().cpu().numpy() for h in heads])
        labels += [it[1] for it in items[:real]]
    del model, forward
    torch.cuda.empty_cache()
    heads = [np.concatenate([p[i] for p in preds]) for i in range(len(preds[0]))]
    if not ek:
        y = np.array(labels)
        err = metrics.topk_errors(heads[0], y, (1, 5))
        return {"top1_err": err[0], "top5_err": err[1]}
    verb = np.array([lab["verb"] for lab in labels])
    noun = np.array([lab["noun"] for lab in labels])
    v = metrics.topk_accuracies(heads[0], verb, (1, 5))
    nn_ = metrics.topk_accuracies(heads[1], noun, (1, 5))
    a = metrics.multitask_topk_accuracies(heads, (verb, noun), (1, 5))
    return {f"{name}_top{k}": acc[i] for name, acc in
            (("verb", v), ("noun", nn_), ("action", a))
            for i, k in enumerate((1, 5))}


def train_engine_case(cfg, drive, tag, ek, per_call):
    """Check one model's train loop. ``drive()`` runs the main path inside
    ``captured_engine`` (TRAIN.CHECKPOINT_FILE_PATH, written first, holds
    a model of seed RNG_SEED + 1). Then: the launches of the loop (12
    kernel-1, 12 kernel-7 calls of ``per_call`` device kernels and 1
    kernel-2 a microbatch, 12 + 1 a val batch, no other version); finite
    losses; the loop against ``direct_train_loop`` (bit-equal, or within
    TRAIN_LOOP_LOSS_REL and TRAIN_LOOP_PARAM_REL); each validation's stats
    against ``direct_val`` on that epoch's checkpoint (VAL_STATS_ATOL);
    the test run (where ``drive`` tests) reading the last checkpoint whole,
    12 + 1 launches a test batch, every clip once; an AUTO_RESUME run from
    the epoch-1 checkpoint ending with the loop's parameters and epoch-2
    losses; a run preempted at its first sync point (PREEMPT_SYNC_PERIOD
    2, the flag set before the run) saving epoch 0 at step 2 and exiting
    0, and the next run replaying epoch 0 from step 2. Reports the loop's
    clips/s (host clock, loader, validation and checkpoints included), its
    wait share (each epoch's first batch's wait with and without), each
    checkpoint save's seconds, validation's clips/s and peak memory, and
    the step's clips/s alone on the same batches."""
    from focus_tpu_torch.engine import trainer
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.utils import checkpoint as cu
    from focus_tpu_torch.utils import preemption

    base = os.path.join(TRAIN_ENGINE_DIR, tag)
    written = build_model(cfg, DEV, seed=cfg.RNG_SEED + 1)
    init = cu.save_checkpoint(base, written, 0, cfg, name="init")
    del written
    torch.cuda.empty_cache()
    cfg.TRAIN.CHECKPOINT_FILE_PATH = init
    cfg.OUTPUT_DIR = os.path.join(base, "run")
    runs = {"train": [], "test": []}
    with captured_engine(runs):
        drive()
    (run, launches, peak_gb), = runs["train"]
    problems = []
    accum = max(int(cfg.TPU.GRAD_ACCUM or 1), 1)
    epochs = cfg.SOLVER.MAX_EPOCH
    val_batches = len(run.val_stats) * -(-TRAIN_ENGINE_VAL // cfg.TRAIN.BATCH_SIZE)
    micro = run.steps * accum
    depth = cfg.MF.DEPTH  # one trajectory core a block, both ways
    expect = {k: 0 for k in launches}
    expect.update({"trajectory_block": depth * (micro + val_batches),
                   "trajectory_block_bwd": depth * micro,
                   "trajectory_block_bwd_device": depth * micro * per_call,
                   "patch_embed": micro + val_batches})
    if launches != expect:
        problems.append(f"loop launches {launches}, expected {expect}")
    flat = [x for epoch in run.losses for x in epoch]
    if not (run.steps == len(flat) and all(math.isfinite(x) for x in flat)):
        problems.append(f"losses {run.losses}")
    if run.checkpoint is None or run.checkpoint.get("missing"):
        problems.append(f"the .pyth was not loaded whole: {run.checkpoint}")
    loop_params = host_params(run.state.model)
    ckpts = [cu.get_path_to_checkpoint(cfg.OUTPUT_DIR, e + 1)
             for e in range(epochs)]
    del run.state
    torch.cuda.empty_cache()

    direct, direct_params, step_seconds, step_clips = direct_train_loop(
        cfg, init, epochs)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(
        flat, [x for epoch in direct for x in epoch]))
    param_rel = params_rel_l2(loop_params, direct_params)
    loop_bit_equal = run.losses == direct and all(
        torch.equal(loop_params[k], direct_params[k]) for k in loop_params)
    if not (loss_rel <= TRAIN_LOOP_LOSS_REL
            and param_rel <= TRAIN_LOOP_PARAM_REL):
        problems.append(f"loop vs direct loop: loss {loss_rel:.3e}, params "
                        f"{param_rel:.3e}")

    val = []
    for stats in run.val_stats:
        want = direct_val(cfg, ckpts[stats["epoch"] - 1], ek)
        err = max(abs(stats[k] - v) for k, v in want.items())
        val.append({"epoch": stats["epoch"], "max_abs_err": err,
                    "stats": stats})
        if sorted(want) != sorted(k for k in stats if k != "epoch") or (
                err > VAL_STATS_ATOL):
            problems.append(f"val stats {stats} vs direct {want}")

    result = {}
    if runs["test"]:
        (test_run, test_launches, test_peak), = runs["test"]
        report = test_run.checkpoint
        meter = test_run.meter
        test_expect = {k: 0 for k in test_launches}
        test_expect.update({"trajectory_block": depth * test_run.batches,
                            "patch_embed": test_run.batches})
        whole = (report["path"] == ckpts[-1] and not report["missing"]
                 and len(report["loaded"]) == len(loop_params))
        once = bool(meter.seen_clips.sum() == test_run.clips)
        if not (whole and once and test_launches == test_expect):
            problems.append(f"test run: checkpoint {report['path']} whole "
                            f"{whole}, every clip once {once}, launches "
                            f"{test_launches}")
        result["test"] = {"stats": test_run.stats, "clips": test_run.clips,
                          "batches": test_run.batches,
                          "checkpoint": os.path.relpath(report["path"], REPO),
                          "loaded_whole": whole,
                          "every_clip_counted_once": once,
                          "launches": test_launches, "peak_memory_gb": test_peak,
                          "test_loop_clips_per_sec":
                              test_run.clips / test_run.seconds}

    # resume: a second job given the epoch-1 checkpoint
    rcfg = cfg.clone()
    rcfg.OUTPUT_DIR = os.path.join(base, "resume")
    os.makedirs(cu.get_checkpoint_dir(rcfg.OUTPUT_DIR))
    os.link(ckpts[0], os.path.join(cu.get_checkpoint_dir(rcfg.OUTPUT_DIR),
                                   os.path.basename(ckpts[0])))
    rcfg.TRAIN.AUTO_RESUME = True
    resumed = trainer.run_train(rcfg, DEV)
    resumed_params = host_params(resumed.state.model)
    resume_rel = params_rel_l2(resumed_params, loop_params)
    resume = {"start_epoch": resumed.start_epoch,
              "losses": resumed.losses, "params_rel_l2": resume_rel,
              "bit_equal": resumed.losses == run.losses[1:] and all(
                  torch.equal(resumed_params[k], loop_params[k])
                  for k in loop_params)}
    if not (resumed.start_epoch == 1 and resume_rel <= TRAIN_LOOP_PARAM_REL):
        problems.append(f"resume: {resume}")
    del resumed, resumed_params
    shutil.rmtree(os.path.join(base, "run"), ignore_errors=True)
    torch.cuda.empty_cache()

    # preemption: the flag set before a run of one epoch
    pcfg = cfg.clone()
    pcfg.OUTPUT_DIR = os.path.join(base, "preempt")
    pcfg.SOLVER.MAX_EPOCH = 1
    pcfg.TRAIN.AUTO_RESUME = True
    pcfg.TPU.PREEMPT_SYNC_PERIOD = 2
    preemption.request_preemption()
    code = None
    try:
        trainer.run_train(pcfg, DEV)
    except SystemExit as e:
        code = e.code
    finally:
        preemption.clear_preemption()
    saved = cu.get_last_checkpoint(pcfg.OUTPUT_DIR)
    torch.cuda.empty_cache()
    replay = trainer.run_train(pcfg, DEV)
    preempt = {"exit_code": code,
               "saved": saved and os.path.basename(saved),
               "replay_start_epoch": replay.start_epoch,
               "replay_steps": replay.steps,
               "replay_resumed_from": replay.checkpoint
               and os.path.basename(replay.checkpoint["path"]),
               "step_after_replay": replay.state.step}
    if not (code == 0 and preempt["saved"] == "checkpoint_epoch_00000.pyth"
            and preempt["replay_resumed_from"] == preempt["saved"]
            and replay.start_epoch == 0
            and replay.state.step == 2 + replay.steps):
        problems.append(f"preemption: {preempt}")
    del replay
    torch.cuda.empty_cache()
    shutil.rmtree(base, ignore_errors=True)

    result.update({
        "ok": not problems, "problems": problems,
        "batch_size": cfg.TRAIN.BATCH_SIZE, "grad_accum": accum,
        "epochs": epochs, "steps": run.steps, "clips": run.clips,
        "losses": run.losses, "val": val,
        "launches": launches,
        "launches_per_train_step": {
            "trajectory_block": depth * accum,
            "trajectory_block_bwd": depth * accum,
            "trajectory_block_bwd_device": depth * accum * per_call,
            "patch_embed": accum},
        "launches_per_val_batch": {"trajectory_block": depth,
                                   "patch_embed": 1},
        "val_batches": val_batches,
        "checkpoint": {k: v for k, v in run.checkpoint.items()
                       if k in ("kind", "path")} | {
            "loaded": len(run.checkpoint["loaded"]),
            "missing": len(run.checkpoint["missing"])},
        "vs_direct_loop": {"bit_equal": loop_bit_equal,
                           "max_loss_rel_err": loss_rel,
                           "params_rel_l2": param_rel,
                           "rule": f"losses within {TRAIN_LOOP_LOSS_REL} "
                                   f"relative, parameters within "
                                   f"{TRAIN_LOOP_PARAM_REL} relative L2"},
        "resume": resume, "preemption": preempt,
        "train_loop_clips_per_sec": run.clips / run.seconds,
        "step_clips_per_sec": step_clips / step_seconds,
        "loop": {"seconds": run.seconds, "wait_seconds": run.wait_seconds,
                 "first_wait_seconds": run.first_wait_seconds,
                 "wait_share": run.wait_seconds / run.seconds,
                 "wait_share_without_first_batches":
                     (run.wait_seconds - run.first_wait_seconds) / run.seconds,
                 "checkpoint_seconds": run.checkpoint_seconds,
                 "val_seconds": run.val_seconds, "val_clips": run.val_clips,
                 "peak_memory_gb": peak_gb},
        "val_clips_per_sec": run.val_clips / run.val_seconds,
        "step_seconds": step_seconds,
    })
    return result, launches


def mixup_on_card():
    """Device mixup on the card: 16 draws from a CUDA generator
    (``sample_mixup``), each applied on the card and, moved to the CPU, on
    the CPU to the same [8, 2, 224, 224, 3] video and labels; the largest
    difference of the mixed videos and soft labels, and the kinds drawn."""
    from focus_tpu_torch.engine.trainer import apply_mixup, sample_mixup
    from focus_tpu_torch.entry import flagship_cfg

    cfg = flagship_cfg()
    cfg.MIXUP.ENABLE = True
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    rs = np.random.RandomState(0)
    video = torch.from_numpy(rs.randn(8, 2, 224, 224, 3).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, 174, 8))
    kinds, err, lams = set(), 0.0, []
    for _ in range(16):
        draws = sample_mixup(cfg, gen, video.shape, DEV)
        got = apply_mixup(video.to(DEV), labels.to(DEV), cfg, draws)
        want = apply_mixup(video, labels, cfg,
                           {k: t.cpu() for k, t in draws.items()})
        err = max([err] + [(g.cpu() - w).abs().max().item()
                           for g, w in zip(got, want)])
        kinds.add("cutmix" if bool(draws["use_cutmix"]) else "mixup")
        lams.append(float(draws["lam"]))
    ok = err <= 1e-6 and all(0.0 <= x <= 1.0 for x in lams)
    return {"ok": ok, "draws": 16, "kinds": sorted(kinds), "lams": lams,
            "max_abs_err_card_vs_cpu": err, "atol": 1e-6}


def phase_train_engine(smi, per_call):
    """The supervised train loop on the card (phase 14), on in-script
    splits (``TrainClips``, ``EKTestClips``): ORViT-MF-HR EK100 16x336 on
    ``configs/ORViT/EK_ORVIT_MF_HR.yaml`` (full width and depth, its
    TRAIN.BATCH_SIZE 16 and solver under EK_loss) through
    ``tools.run_net.main``: 2 epochs of 4 steps, validation and a
    checkpoint after each, fine-tuned from a ``.pyth`` of another seed,
    then the test path on 60 clips; and the flagship SSv2 16x224
    (``entry.flagship_cfg`` with the SSv2 yaml's solver and drop path) at
    its TRAIN.BATCH_SIZE 48 under TPU.GRAD_ACCUM 2, 2 epochs of 2 steps,
    through ``engine.trainer.train``. Each is held by
    ``train_engine_case``; device mixup by ``mixup_on_card``. The
    package's log goes to TRAIN_ENGINE_LOG. Returns the two loops'
    launches."""
    from focus_tpu_torch.config.defaults import assert_and_infer_cfg
    from focus_tpu_torch.engine import trainer
    from focus_tpu_torch.entry import flagship_cfg
    from focus_tpu_torch.tools import run_net
    from focus_tpu_torch.utils import logging as port_logging
    from focus_tpu_torch.utils.parser import load_config, parse_args

    shutil.rmtree(TRAIN_ENGINE_DIR, ignore_errors=True)
    os.makedirs(TRAIN_ENGINE_DIR)
    yaml = os.path.join(REPO, "configs", "ORViT", "EK_ORVIT_MF_HR.yaml")
    argv = ["--device", DEV, "--cfg", yaml, "--exp_name", "chip_smoke",
            "TRAIN.METHOD", "sup", "TEST.EVAL_TASK", "ar",
            "MODEL.LOSS_FUNC", "EK_loss", "SOLVER.MAX_EPOCH", "2",
            "TRAIN.EVAL_PERIOD", "1", "TRAIN.CHECKPOINT_PERIOD", "1",
            "LOG_PERIOD", "2"]
    hr = assert_and_infer_cfg(load_config(parse_args(argv)))
    assert hr.TRAIN.BATCH_SIZE == 16, hr.TRAIN.BATCH_SIZE

    fl = flagship_cfg()
    fl.MODEL.ARCH = "slow"
    fl.TRAIN.DATASET = "chip_train_ssv2"
    fl.TRAIN.BATCH_SIZE = FLAGSHIP_TRAIN_BATCH
    fl.TPU.GRAD_ACCUM = FLAGSHIP_GRAD_ACCUM
    s = fl.SOLVER  # configs/ORViT/SSv2_ORViT-MF_224_16x4.yaml's, 2 epochs
    s.OPTIMIZING_METHOD, s.BASE_LR, s.WEIGHT_DECAY = "adamw", 5e-5, 5e-2
    s.LR_POLICY, s.LRS, s.STEPS = "steps_with_relative_lrs", [1, 0.1, 0.01], \
        [0, 20, 30]
    s.MAX_EPOCH, s.WARMUP_EPOCHS, s.MOMENTUM = 2, 0.0, 0.9
    fl.MF.DROP_PATH = 0.2
    fl.TRAIN.EVAL_PERIOD = fl.TRAIN.CHECKPOINT_PERIOD = 1
    fl.TRAIN.AUTO_RESUME = fl.TRAIN.CHECKPOINT_EPOCH_RESET = True
    fl.DATA_LOADER.NUM_WORKERS = 6  # as the SSv2 yaml
    fl.LOG_PERIOD = 1

    splits = {"Epickitchens": chip_splits(True, HR_TRAIN_STEPS * 16,
                                          TRAIN_ENGINE_VAL),
              "Chip_train_ssv2": chip_splits(
                  False, FLAGSHIP_TRAIN_STEPS * FLAGSHIP_TRAIN_BATCH,
                  TRAIN_ENGINE_VAL)}
    result = {"phase": "train_engine", "gpu": smi}
    launches = []
    try:
        with open(TRAIN_ENGINE_LOG, "w") as log, \
                contextlib.redirect_stdout(log), registered_splits(splits), \
                epoch_seeded_splits():
            case, counts = train_engine_case(
                hr, lambda: run_net.main(argv + [
                    "TRAIN.CHECKPOINT_FILE_PATH",
                    hr.TRAIN.CHECKPOINT_FILE_PATH,
                    "OUTPUT_DIR", hr.OUTPUT_DIR]), "hr336", True, per_call)
            launches.append(counts)
            result["hr336_ek"] = {
                "model": "ORViT-MF-HR EK100 16x336 (configs/ORViT/"
                         "EK_ORVIT_MF_HR.yaml through tools.run_net, "
                         "EK_loss), D=768, 12 layers, 12 heads, bf16 "
                         "(float32 masters); 2 epochs of 4 steps at batch "
                         "16, 40 val clips, then 2 videos x 10 views x 3 "
                         "crops tested",
                **case}
            case, counts = train_engine_case(
                fl, lambda: trainer.train(fl, device=DEV), "flagship", False,
                per_call)
            launches.append(counts)
            result["flagship_ssv2"] = {
                "model": "ORViT-MF SSv2 16x224 (entry.flagship_cfg with the "
                         "SSv2 yaml's solver and drop path 0.2, through "
                         "engine.trainer.train), D=768, 12 layers, 12 heads, "
                         "bf16 (float32 masters); 2 epochs of 2 steps at "
                         f"batch {FLAGSHIP_TRAIN_BATCH} under TPU.GRAD_ACCUM "
                         f"{FLAGSHIP_GRAD_ACCUM}, 40 val clips",
                **case}
        result["mixup"] = mixup_on_card()
    finally:
        port_logging.close_logging()
        shutil.rmtree(TRAIN_ENGINE_DIR, ignore_errors=True)
    result["ok"] = (result["hr336_ek"]["ok"] and result["flagship_ssv2"]["ok"]
                    and result["mixup"]["ok"])
    emit(result)
    if not result["ok"]:
        raise AssertionError("train engine phase failed")
    return launches


# STEVE training and its segmentation eval (phase 15): the MOVi-E recipe
# (configs/movi_e/base.yaml) at its width on synthetic clips (the checkout
# holds no MOVi-E PNGs), through tools.run_net, then
# the trained model rolled out through kernel 9. The package's log goes to
# SLOT_TRAIN_LOG, not to stdout.
SLOT_TRAIN_DIR = os.path.join(REPO, "build", "slot_train")
SLOT_TRAIN_LOG = os.path.join(REPO, "build", "slot_train.log")
SLOT_YAML = os.path.join(REPO, "configs", "movi_e", "base.yaml")
SLOT_EPOCHS = 2  # of 4 steps: synthetic_video's 64 train clips at batch 16
SLOT_BATCH = 16  # the recipe's TRAIN.BATCH_SIZE
SLOT_WARMUP_STEPS = 2
SLOT_TIMED_STEPS = 10  # on one fixed batch: the loss must fall over them
SLOT_PROFILED_STEPS = 3
SLOT_TEST_CLIPS = 16  # synthetic_video_with_masks's test split
# one step at batch 2 in float32, on the card against the CPU, from the same
# weights and the same noise (Gumbel and slot noise drawn on the host and
# passed to both, dropout at 0 on both; dropout is held on the CPU by the
# tests): the loss within SLOT_LOSS_REL of it, the whole gradient (every
# parameter's together) within SLOT_GRAD_REL of its norm (relative L2), and
# each parameter's within SLOT_GRAD_TENSOR_REL: the CPU's own float32
# gradient of a parameter can stand ~1e-3 from float64's, so a float32
# reference cannot hold one parameter's gradient to 1e-3. Where it stands
# furthest, the dVAE decoder, the card's float32 gradients are held against
# float64 on the step's weights and tokens instead (slot_dvae_float32_error:
# each within SLOT_GRAD_REL), and the CPU's are reported beside them. A
# gradient zero but for rounding (BatchNorm removes the bias before it; one
# bias shifts every slot's logits alike) within SLOT_ZERO_GRAD of the whole
# gradient's norm
SLOT_CMP_BATCH = 2
SLOT_LOSS_REL = 1e-4
SLOT_GRAD_REL = 1e-3
SLOT_GRAD_TENSOR_REL = 5e-3
SLOT_ZERO_GRAD = 1e-6


def slot_argv(exp_name):
    """``tools.run_net``'s arguments: the MOVi-E recipe with the synthetic
    datasets, two-frame clips, SLOT_EPOCHS epochs, then the eval."""
    return ["--device", DEV, "--cfg", SLOT_YAML, "--exp_name", exp_name,
            "OUTPUT_DIR", SLOT_TRAIN_DIR,
            "TRAIN.DATASET", "synthetic_video",
            "TEST.DATASET", "synthetic_video_with_masks",
            "DATA.NUM_FRAMES", "2", "SOLVER.MAX_EPOCH", str(SLOT_EPOCHS),
            "TEST.ENABLE", "True", "LOG_PERIOD", "2"]


@contextlib.contextmanager
def captured_slot_engine(runs):
    """``slot_trainer.slot_train`` and ``slot_eval``, as ``tools.run_net``
    calls them, keeping their SlotTrainRun / SlotEvalRun in ``runs``."""
    from focus_tpu_torch.engine import slot_trainer as st

    train, evaluate = st.slot_train, st.slot_eval

    def kept_train(cfg, device="cuda"):
        runs["train"] = st.run_slot_train(cfg, device)
        return runs["train"].state

    def kept_eval(cfg, device="cuda"):
        runs["eval"] = st.run_slot_eval(cfg, device)
        return runs["eval"].results

    st.slot_train, st.slot_eval = kept_train, kept_eval
    try:
        yield
    finally:
        st.slot_train, st.slot_eval = train, evaluate


def slot_test_video(cfg):
    """synthetic_video_with_masks's test clips [16, 2, 64, 64, 3] on the
    card: the rollout's 32 rows."""
    from focus_tpu_torch.datasets.build import build_dataset

    data = build_dataset(cfg.TEST.DATASET, cfg, "test")
    video = np.stack([data[i][0] for i in range(len(data))])
    return torch.from_numpy(video).to(DEV)


def slot_step_noise(cfg, B, T):
    """The noise of one train step, drawn on the host from seed 0: the two
    Gumbel noises [B*T, h, w, V] and the slot noise [B, S, D], as
    ``STEVE.forward`` takes them."""
    gen = torch.Generator().manual_seed(0)
    h = cfg.SLOTS.IMG_SIZE // 4
    tiny = torch.finfo(torch.float32).tiny
    gumbel = [-torch.log(torch.empty(B * T, h, h, cfg.SLOTS.VOCAB_SIZE)
                         .exponential_(generator=gen) + tiny)
              for _ in range(2)]
    slots = torch.randn(B, cfg.SLOTS.NUM_SLOTS, cfg.SLOTS.SIZE,
                        generator=gen)
    return {"gumbel": gumbel, "slots": slots}


def without_dropout(model):
    """``model`` with every dropout rate set to 0 (the position embedding's
    fixed 0.1 too)."""
    for m in model.modules():
        if isinstance(getattr(m, "dropout", None), float):
            m.dropout = 0.0
    return model


def slot_grads_card_vs_cpu():
    """One ``steve_train_entry`` step at batch 2 in float32 on the card and
    on the CPU from the card model's weights, on the same host-drawn noise
    and without dropout: the loss and every parameter's gradient."""
    from focus_tpu_torch.entry import steve_train_cfg, steve_train_entry

    card, (video,) = steve_train_entry(device=DEV, batch=SLOT_CMP_BATCH,
                                       float32=True)
    host, _ = steve_train_entry(device="cpu", batch=SLOT_CMP_BATCH,
                                float32=True)
    host.model.load_state_dict(host_params(card.model))
    for fn in (card, host):
        without_dropout(fn.model)
    noise = slot_step_noise(steve_train_cfg(float32=True), *video.shape[:2])
    on_card = {"gumbel": [g.to(DEV) for g in noise["gumbel"]],
               "slots": noise["slots"].to(DEV)}
    ids = slot_step_tokens(host.model, video.cpu(), noise["gumbel"][0])
    float32_error = {side: slot_dvae_float32_error(
        host.model.dvae.decoder, ids, video.cpu(), dev)
        for side, dev in (("card", DEV), ("cpu", "cpu"))}
    card_float32 = max(float32_error["card"].values())
    got, ref = card(video, on_card), host(video.cpu(), noise)
    loss_rel = abs(float(got["loss"]) - float(ref["loss"])) / abs(
        float(ref["loss"]))
    grads = {n: (p.grad.float().cpu(), dict(host.model.named_parameters())[
        n].grad) for n, p in card.model.named_parameters()}
    total = math.sqrt(sum(float(r.double().pow(2).sum())
                          for _, r in grads.values()))
    whole = math.sqrt(sum(float((g.double() - r.double()).pow(2).sum())
                          for g, r in grads.values())) / total
    worst, worst_zero, bad, rels = 0.0, 0.0, [], {}
    for name, (g, r) in grads.items():
        diff = float((g.double() - r.double()).norm())
        norm = float(r.double().norm())
        if norm > SLOT_ZERO_GRAD * total:
            rels[name] = diff / norm
            worst = max(worst, diff / norm)
            if diff > SLOT_GRAD_TENSOR_REL * norm:
                bad.append((name, diff / norm))
        else:
            worst_zero = max(worst_zero, diff / total)
            if diff > SLOT_ZERO_GRAD * total:
                bad.append((name, diff / total))
    ok = (loss_rel <= SLOT_LOSS_REL and whole <= SLOT_GRAD_REL and not bad
          and card_float32 <= SLOT_GRAD_REL
          and all(bool(torch.isfinite(g).all()) for g, _ in grads.values()))
    return ok, {"batch": SLOT_CMP_BATCH, "dtype": "float32, TF32 off",
                "loss_card": float(got["loss"]), "loss_cpu": float(ref["loss"]),
                "loss_rel_err": loss_rel, "params": len(grads),
                "whole_grad_rel_l2": whole,
                "max_grad_rel_l2": worst,
                "worst_grads": sorted(rels.items(), key=lambda kv: -kv[1])[:6],
                "dvae_decoder_float32_vs_float64": float32_error,
                "max_zero_grad_err_over_total_norm": worst_zero,
                "beyond_tolerance": bad[:8],
                "tolerance": f"loss {SLOT_LOSS_REL} relative; the whole "
                             f"gradient {SLOT_GRAD_REL} relative L2, each "
                             f"parameter's {SLOT_GRAD_TENSOR_REL}, the card's "
                             f"dVAE decoder against float64 {SLOT_GRAD_REL}, "
                             "a gradient "
                             f"under {SLOT_ZERO_GRAD} of the whole gradient's "
                             "norm (zero but for rounding) within that of it"}


@torch.no_grad()
def slot_step_tokens(model, video, g_soft):
    """The tokens the step's dVAE decoder takes from ``video`` [B, T, H, W,
    C] on the CPU: the argmax of the dVAE encoder's log-probabilities plus
    z_soft's Gumbel noise ``g_soft``, [B*T, h, w]."""
    B, T, H, W, C = video.shape
    logits = torch.nn.functional.log_softmax(model.dvae.encoder(
        video.reshape(B * T, H, W, C)).float(), dim=-1)
    return (logits + g_soft).argmax(-1)


def slot_dvae_float32_error(decoder, ids, video, device):
    """A copy of the dVAE ``decoder``'s gradients of the summed squared
    error against ``video`` [B, T, H, W, C] from the one-hot ``ids`` (the
    step's mse term) in float32 against float64 on ``device``: {name:
    relative L2} of the four worst among its parameters' and the tokens'
    ("input")."""
    import copy

    dec = copy.deepcopy(decoder)
    V = dec[0].m.in_channels
    target = video.reshape(-1, *video.shape[2:])
    grads = {}
    for dt in (torch.float32, torch.float64):
        d = dec.to(device, dt)
        d.zero_grad(set_to_none=True)
        z = torch.nn.functional.one_hot(ids, V).to(device, dt).requires_grad_()
        ((target.to(device, dt) - d(z)) ** 2).sum().backward()
        grads[dt] = {n: p.grad.double().cpu() for n, p in d.named_parameters()}
        grads[dt]["input"] = z.grad.double().cpu()
    a, b = grads[torch.float32], grads[torch.float64]
    rels = sorted(((float((a[k] - b[k]).norm() / b[k].norm()), k) for k in a),
                  reverse=True)
    return {k: r for r, k in rels[:4]}


def slot_steps_on_card(smi):
    """``steve_train_entry`` at the recipe's batch 16, bf16, on one fixed
    batch: SLOT_WARMUP_STEPS, then SLOT_TIMED_STEPS each timed by CUDA
    events and together on the host clock (the loss must fall over them),
    then SLOT_PROFILED_STEPS under torch.profiler for the device's busy
    share; the peak of allocated memory over the timed steps."""
    from torch.profiler import ProfilerActivity, profile

    from focus_tpu_torch.entry import steve_train_entry
    from focus_tpu_torch.profile_slice import _busy_us

    fn, (video,) = steve_train_entry(device=DEV, batch=SLOT_BATCH)
    losses = [fn(video)["loss"] for _ in range(SLOT_WARMUP_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    t0 = time.perf_counter()
    for _ in range(SLOT_TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(fn(video)["loss"])
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = [a.elapsed_time(b) for a, b in times]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        p0 = time.perf_counter()
        for _ in range(SLOT_PROFILED_STEPS):
            fn(video)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - p0) / SLOT_PROFILED_STEPS
    busy_us, _ = _busy_us(prof)
    busy_ms = busy_us / 1e3 / SLOT_PROFILED_STEPS
    losses = torch.stack(losses).tolist()
    frames = SLOT_BATCH * video.shape[1]
    ok = all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    return ok, {"batch": SLOT_BATCH, "frames_per_clip": int(video.shape[1]),
                "dtype": "bf16 (float32 masters)",
                "losses": losses, "loss_fell": losses[-1] < losses[0],
                "step_ms_cuda_events_median": statistics.median(ms),
                "step_ms_cuda_events": ms,
                "train_clips_per_sec": SLOT_BATCH * SLOT_TIMED_STEPS / seconds,
                "train_frames_per_sec": frames * SLOT_TIMED_STEPS / seconds,
                "peak_memory_gb": peak_gb,
                "profiled_wall_ms_per_step": wall_ms,
                "device_busy_ms_per_step": busy_ms if busy_us else
                "not measured",
                "device_busy_share": busy_ms / wall_ms if busy_us else
                "not measured", "gpu": smi}


def slot_rollout(cfg, best, per_step):
    """The trained model rolled out: a fresh STEVE of the recipe loaded from
    ``best`` (best_model.pt), ``reconstruct_autoregressive`` of the 16 test
    clips (32 rows) through kernel 9, the first rollout capturing its graph
    and STEVE_ITERS more replaying it, counted from zero. Returns the
    report, the counts, the model and its slots."""
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.ops import ar_decode as ar
    from focus_tpu_torch.utils import checkpoint as cu

    model = build_model(cfg, DEV)
    report = cu.load_checkpoint(best, model, cfg)
    video = slot_test_video(cfg)
    gen = torch.Generator(device=DEV)
    rows = video.shape[0] * video.shape[1]
    gen_len = (model.image_size // 4) ** 2
    torch.cuda.synchronize()
    captures = ar.GRAPH_CAPTURES
    reset_ar_counts(ar)
    gen.manual_seed(0)
    recon, first_s = timed(lambda: model.reconstruct_autoregressive(
        video, generator=gen))
    times = []
    for _ in range(STEVE_ITERS):
        gen.manual_seed(0)
        times.append(timed(lambda: model.reconstruct_autoregressive(
            video, generator=gen))[1])
    got = ar_counts(ar)
    rollouts = 1 + STEVE_ITERS
    counts = {"wrapper": got["bf16"], "device": got["bf16_device"]}
    expect = {"wrapper": 1 + gen_len * rollouts,
              "device": (1 + gen_len * rollouts) * per_step}
    if (counts != expect or got["bf16_pdl"] != counts["device"]
            or got["graph_replays"] != rollouts or got["w8a8"]
            or ar.GRAPH_CAPTURES != captures + 1):
        raise AssertionError(
            f"trained-model rollout launches {got}, captures "
            f"{ar.GRAPH_CAPTURES - captures}, expected {expect} (one warm "
            f"step at the capture, then {rollouts} replays of {gen_len} steps "
            f"x {per_step} kernels, all with PDL) and one capture")
    recon = recon.float()
    ok = (tuple(recon.shape) == tuple(video.shape)
          and bool(torch.isfinite(recon).all())
          and recon.min().item() >= 0.0 and recon.max().item() <= 1.0)
    if not ok:
        raise AssertionError("trained STEVE's reconstruction: bad shape or "
                             "values")
    gen.manual_seed(0)
    slots = model.encode(video, generator=gen)[0].reshape(
        rows, model.num_slots, -1)
    seconds = statistics.median(times)
    return {"checkpoint": os.path.basename(best),
            "checkpoint_loaded": len(report["loaded"]),
            "checkpoint_missing": report["missing"],
            "rows": rows, "steps_per_rollout": gen_len,
            "counted_rollouts": rollouts,
            "first_rollout_ms_incl_packing_and_capture": 1e3 * first_s,
            "ms_per_rollout_median": 1e3 * seconds,
            "frames_per_sec": rows / seconds}, counts, model, slots


def slot_graph_follows_weights(cfg, best, model, slots):
    """A fresh model rolled out at its initial weights (a capture), then
    ``best`` loaded into it and rolled out again: a second capture, and the
    ids of the trained model's rollout from the same slots."""
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.ops import ar_decode as ar
    from focus_tpu_torch.utils import checkpoint as cu

    fresh = build_model(cfg, DEV)
    before = ar.GRAPH_CAPTURES
    ids_init = fresh.decode_ids(slots)
    cu.load_checkpoint(best, fresh, cfg)
    ids_loaded = fresh.decode_ids(slots)
    captures = ar.GRAPH_CAPTURES - before
    same = torch.equal(ids_loaded, model.decode_ids(slots))
    fresh.free_rollout_graphs()
    return captures == 2 and same, {
        "captures": captures, "ids_equal_trained_model": same,
        "ids_changed_with_the_weights": not torch.equal(ids_init, ids_loaded)}


def phase_slot_train(smi):
    """STEVE training and its segmentation eval on the card (phase 15): the
    MOVi-E recipe (configs/movi_e/base.yaml: res18 encoder, 64 px, 15
    slots of 192, decoder D=192 x 4 blocks x 4 heads, vocabulary 4096, bf16,
    the three-group Adam behind clipping at 0.05) on synthetic_video /
    synthetic_video_with_masks with two-frame clips, through
    ``tools.run_net``: SLOT_EPOCHS epochs of 4 steps at batch 16 with
    validation and the three checkpoint names, then ``slot_eval`` of the
    epoch-1 checkpoint (TEST.TEST_EPOCH_NUM 1) on 16 clips; then
    best_model.pt loaded into a fresh model and rolled out through kernel 9
    at 32 rows. Counts are zeroed before the run and read after the
    rollout. Then the step on the card against the CPU in float32, the
    loss falling over the timed steps on a fixed batch, the rollout's graph
    recaptured for loaded weights and its ids and logits against the plain
    path. Returns kernel 9's counts."""
    from focus_tpu_torch.config.defaults import assert_and_infer_cfg
    from focus_tpu_torch.ops import ar_decode as ar
    from focus_tpu_torch.tools import run_net
    from focus_tpu_torch.utils import logging as port_logging
    from focus_tpu_torch.utils.parser import load_config, parse_args

    per_step = ar.launches_per_step(4)
    shutil.rmtree(SLOT_TRAIN_DIR, ignore_errors=True)
    os.makedirs(SLOT_TRAIN_DIR)
    argv = slot_argv("chip_smoke")
    cfg = assert_and_infer_cfg(load_config(parse_args(argv)))
    assert (cfg.TRAIN.BATCH_SIZE, cfg.SLOTS.DECODER.DIM,
            cfg.MODEL.CNN_NAME) == (SLOT_BATCH, 192, "res18")
    cfg.EXP.PATH = os.path.join(cfg.OUTPUT_DIR, "chip_smoke")
    ckpt_dir = os.path.join(cfg.EXP.PATH, "checkpoints")
    best = os.path.join(ckpt_dir, "best_model.pt")
    result = {"phase": "slot_train", "gpu": smi,
              "model": "STEVE, configs/movi_e/base.yaml through "
                       "tools.run_net: res18 encoder, 64 px, 15 slots of "
                       "192, 2 corrector iterations, decoder D=192 x 4 "
                       "blocks x 4 heads, vocabulary 4096, bf16 (float32 "
                       "masters), Adam in three groups, clipping 0.05; "
                       "synthetic_video / synthetic_video_with_masks, "
                       f"two-frame clips, {SLOT_EPOCHS} epochs of 4 steps "
                       "at batch 16"}
    runs = {}
    try:
        with open(SLOT_TRAIN_LOG, "w") as log, contextlib.redirect_stdout(log):
            torch.cuda.synchronize()
            reset_ar_counts(ar)
            with captured_slot_engine(runs):
                results, loop_s = timed(lambda: run_net.main(argv))
            rollout, counts, model, slots = slot_rollout(cfg, best, per_step)
            tr, ev = runs["train"], runs["eval"]
            names = sorted(os.listdir(ckpt_dir))
            losses = [x for epoch in tr.losses for x in epoch]
            checks = {
                "losses_finite": all(math.isfinite(x) for x in losses)
                and all(math.isfinite(x) for x in tr.val_losses),
                "steps": tr.steps == SLOT_EPOCHS * 4,
                "checkpoints": names == [
                    "best_model.pt", "checkpoint.pt.tar",
                    *[f"checkpoint_epoch_{e:05d}.pyth"
                      for e in range(1, SLOT_EPOCHS + 1)]],
                "eval_checkpoint": ev.checkpoint is not None and ev.checkpoint[
                    "path"].endswith("checkpoint_epoch_00001.pyth")
                and not ev.checkpoint["missing"],
                "test_clips_once": ev.clips == SLOT_TEST_CLIPS,
                "val_clips_once": tr.val_clips == SLOT_EPOCHS * 16,
                # mBO is a mean IoU; FG-ARI an adjusted Rand index, which
                # falls below 0 for a clustering worse than chance
                "scores_in_range": all(math.isfinite(results[k])
                                       for k in ("fg_ari", "mbo"))
                and -100.0 <= results["fg_ari"] <= 100.0
                and 0.0 <= results["mbo"] <= 100.0,
                "rollout_loaded_whole": not rollout["checkpoint_missing"],
            }
            result["train"] = {
                "losses": tr.losses, "taus": tr.taus,
                "val_losses": tr.val_losses, "steps": tr.steps,
                "checkpoints": names,
                "loop_clips_per_sec": tr.clips / tr.seconds,
                "loop_seconds": tr.seconds,
                "wait_seconds": tr.wait_seconds,
                "save_seconds": tr.save_seconds,
                "val_clips": tr.val_clips,
                "val_clips_per_sec": tr.val_clips / tr.val_seconds}
            result["eval"] = {
                **results, "clips": ev.clips, "batches": len(ev.fg_aris),
                "checkpoint": os.path.basename(ev.checkpoint["path"]),
                "clips_per_sec": ev.clips / ev.seconds,
                "wait_seconds": ev.wait_seconds}
            result["run_net_seconds"] = loop_s
            result["rollout"] = rollout
            result["kernel_9_counts"] = counts
            ok, result["vs_plain_path"] = ids_vs_plain_path(model, slots)
            checks["rollout_vs_plain_path"] = ok
            result["graph_vs_per_call"] = graph_vs_per_call(model, slots)
            ok, result["graph_follows_weights"] = slot_graph_follows_weights(
                cfg, best, model, slots)
            checks["graph_recaptured"] = ok
            model.free_rollout_graphs()
            del model, slots
            torch.cuda.empty_cache()
            ok, result["card_vs_cpu"] = slot_grads_card_vs_cpu()
            checks["card_vs_cpu"] = ok
            ok, result["steps_on_card"] = slot_steps_on_card(smi)
            checks["loss_falls"] = ok
    finally:
        port_logging.close_logging()
        shutil.rmtree(SLOT_TRAIN_DIR, ignore_errors=True)
    result["checks"] = checks
    result["ok"] = all(checks.values())
    emit(result)
    if not result["ok"]:
        raise AssertionError(
            f"slot train phase failed: "
            f"{sorted(k for k, v in checks.items() if not v)}")
    return counts


# The ResNet video family (phase 16): SlowFast 8x8 R50 on Kinetics-400
# (configs/Kinetics/SLOWFAST_8x8_R50.yaml) at full width, and X3D-M. No
# hand-written kernel: the convolutions are F.conv3d (cuDNN), BatchNorm
# models/norms.py's in float32. The package's log goes to CONV_ENGINE_LOG.
CONV_ENGINE_DIR = os.path.join(REPO, "build", "conv_engine")
CONV_ENGINE_LOG = os.path.join(REPO, "build", "conv_engine.log")
KINETICS = os.path.join(REPO, "configs", "Kinetics")
CONV_FIXTURE_ATOL = 5e-5  # tests/test_conv_full_golden.py's
CONV_BATCH = 8  # the yaml's TRAIN.BATCH_SIZE 64 over NUM_GPUS 8
CONV_EVAL_ITERS = 10
CONV_TRAIN_WARMUP, CONV_TRAIN_ITERS = 2, 5
# bf16 against float32 on the same weights and clips: each probability
# within this share of the largest (~50 layers, each rounding its output
# to bf16, 2^-9 relative)
CONV_PROB_REL = 0.05
# X3D-M's step in bf16 against float32 from the same weights and batch
CONV_BF16_LOSS_REL = 2e-2
CONV_BF16_GRAD_COS = 0.99
# SlowFast's step at batch 2 in float32, the card against the CPU from the
# same weights and batch (cuDNN's and the CPU's sums in another order)
CONV_LOSS_REL = 1e-4
CONV_GRAD_REL_L2 = 1e-3
CONV_STATS_REL = 1e-4
# a gradient whose two float32 forms lie farther apart than
# CONV_GRAD_REL_L2: the card's within this of the float64 gradient (the
# fast pathway's BatchNorm parameters and the convolutions behind them:
# both devices' float32 lie ~1e-3 or more from float64 there)
CONV_F64_REL_L2 = 1e-2
CONV_LOOP_ATOL = 1e-3  # the ensembled (summed) probabilities, direct loop
# the loops' in-script Kinetics splits: 4 train steps an epoch at batch 8,
# two val batches, 4 test videos x 1 view x 3 crops
CONV_TRAIN_CLIPS, CONV_VAL_CLIPS, CONV_TEST_VIDEOS = 32, 16, 4
CONV_PRECISE_BATCHES = 2  # BN.NUM_BATCHES_PRECISE, cut from the yaml's 200
CONV_FORMATS = (("ncdhw", torch.contiguous_format),
                ("channels_last_3d", torch.channels_last_3d))
CONV_FORMAT_NAMES = {fmt: name for name, fmt in CONV_FORMATS}


def conv_fixture_cfg(name):
    """The configs of the reference's executed conv-family fixtures
    (``scripts/make_golden_fixtures.py``, as ``tests/test_conv_full_golden.py``
    mirrors them), float32."""
    from focus_tpu_torch.config import get_cfg

    p = 2 if name.startswith("slowfast") else 1
    cfg = get_cfg()
    cfg.MODEL.NUM_CLASSES = 9
    cfg.DATA.NUM_FRAMES = 8 if p == 2 else 4
    cfg.DATA.TRAIN_CROP_SIZE = 64
    cfg.DATA.INPUT_CHANNEL_NUM = [3] * p
    cfg.RESNET.DEPTH, cfg.RESNET.NUM_GROUPS = 50, 1
    cfg.RESNET.WIDTH_PER_GROUP = 8
    cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[n] * p for n in (3, 4, 6, 3)]
    cfg.RESNET.SPATIAL_STRIDES = [[1] * p] + [[2] * p] * 3
    cfg.RESNET.SPATIAL_DILATIONS = [[1] * p] * 4
    cfg.NONLOCAL.LOCATION = [[[]] * p] * 4
    cfg.NONLOCAL.GROUP = [[1] * p] * 4
    cfg.TPU.COMPUTE_DTYPE = "float32"
    if p == 2:
        cfg.MODEL.MODEL_NAME, cfg.MODEL.ARCH = "SlowFast", "slowfast"
        cfg.SLOWFAST.ALPHA, cfg.SLOWFAST.BETA_INV = 4, 8
        cfg.SLOWFAST.FUSION_CONV_CHANNEL_RATIO = 2
        cfg.SLOWFAST.FUSION_KERNEL_SZ = 5
        cfg.NONLOCAL.LOCATION = [[[], []], [[], []], [[1], []], [[], []]]
        cfg.NONLOCAL.INSTANTIATION = "dot_product"
    if name == "slowfast_det_full":
        cfg.DETECTION.ENABLE = cfg.DETECTION.ALIGNED = True
        cfg.DETECTION.ROI_XFORM_RESOLUTION = 7
        cfg.DETECTION.SPATIAL_SCALE_FACTOR = 16
        cfg.RESNET.SPATIAL_STRIDES = [[1, 1], [2, 2], [2, 2], [1, 1]]
        cfg.RESNET.SPATIAL_DILATIONS = [[1, 1], [1, 1], [1, 1], [2, 2]]
        cfg.MODEL.HEAD_ACT = "sigmoid"
    if name == "slow_full":
        cfg.MODEL.MODEL_NAME, cfg.MODEL.ARCH = "ResNet", "slow"
        cfg.NONLOCAL.LOCATION = [[[]], [[1]], [[]], [[]]]
        cfg.NONLOCAL.INSTANTIATION = "softmax"
    if name == "x3d_full":
        cfg.MODEL.MODEL_NAME, cfg.MODEL.ARCH = "X3D", "x3d"
        cfg.RESNET.TRANS_FUNC, cfg.RESNET.STRIDE_1X1 = "x3d_transform", False
        cfg.X3D.DIM_C1, cfg.X3D.WIDTH_FACTOR, cfg.X3D.DEPTH_FACTOR = 12, 1.5, 1.0
        cfg.X3D.BOTTLENECK_FACTOR, cfg.X3D.DIM_C5 = 2.25, 64
        cfg.X3D.CHANNELWISE_3x3x3, cfg.X3D.SCALE_RES2 = True, False
        cfg.X3D.BN_LIN5 = False
    return cfg


@torch.no_grad()
def conv_fixtures():
    """(a) The four fixtures of the executed reference on the card in
    float32, their state dicts read by the checkpoint reader's
    ``import_state_dict``: max |err| of each."""
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.utils import checkpoint as cu

    errs = {}
    for name in ("slowfast_full", "slowfast_det_full", "slow_full",
                 "x3d_full"):
        d = dict(np.load(os.path.join(REPO, "tests", "fixtures",
                                      f"{name}.npz")))
        sd = {k[3:]: torch.from_numpy(v) for k, v in d.items()
              if k.startswith("sd/")}
        model = build_model(conv_fixture_cfg(name), DEV)
        report = cu.import_state_dict(sd, model)
        if report["missing"] or report["unused"]:
            raise AssertionError(f"fixture {name}: {report['missing']} "
                                 f"missing, {report['unused']} unused")
        v = torch.from_numpy(d["video"].transpose(0, 2, 3, 4, 1).copy())
        xs = [v[:, ::4].contiguous(), v] if "slowfast" in name else [v]
        boxes = torch.from_numpy(d["boxes"]).to(DEV) if "boxes" in d else None
        out = model([x.to(DEV) for x in xs], bboxes=boxes)
        errs[name] = (out.float().cpu().reshape(d["out"].shape)
                      - torch.from_numpy(d["out"])).abs().max().item()
    return errs


def same_probs(got, want, rel):
    """Max |got - want| of two probability tables, its bound (``rel`` of
    the largest), and their top-1 agreement."""
    err = (got.float() - want.float()).abs().max().item()
    bound = rel * want.abs().max().item()
    top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    return {"max_abs_err": err, "bound": bound, "ok": err <= bound,
            "top1_agreement": top1}


def slowfast_eval():
    """(b) ``slowfast_entry(batch=8)``: the eval forward at the 256 test
    crop in bf16, clips/s by CUDA events (median) in dense NCDHW and in
    channels_last_3d, in turns, peak memory, and the probabilities against
    the same weights and clips in float32."""
    from focus_tpu_torch.entry import slowfast_entry

    fn, (xs,) = slowfast_entry(device=DEV, batch=CONV_BATCH)
    model = fn.model
    times = {name: [] for name, _ in CONV_FORMATS}
    torch.cuda.reset_peak_memory_stats()
    for name, fmt in CONV_FORMATS + CONV_FORMATS[::-1]:
        model.memory_format = fmt
        times[name].append(time_ms(lambda: fn(xs), warmup=2,
                                   iters=CONV_EVAL_ITERS))
    peak = torch.cuda.max_memory_allocated() / 1e9
    model.memory_format = type(model).memory_format
    probs = fn(xs)
    dtype, model.dtype = model.dtype, torch.float32
    probs32 = fn(xs)
    model.dtype = dtype
    ms = {k: statistics.median(v) for k, v in times.items()}
    best = min(ms, key=ms.get)
    result = {
        "model": "SlowFast 8x8 R50, Kinetics-400 (configs/Kinetics/"
                 "SLOWFAST_8x8_R50.yaml), bf16, the JAX package's "
                 "initialisers (seed 0)",
        "clips": [list(x.shape) for x in xs], "batch": CONV_BATCH,
        "default_memory_format": CONV_FORMAT_NAMES[type(model).memory_format],
        "ms": ms, "ms_in_turns": times, "faster_format": best,
        "clips_per_sec": {k: CONV_BATCH / (v / 1e3) for k, v in ms.items()},
        "peak_memory_gb": peak,
        "probs_shape": list(probs.shape),
        "finite": bool(torch.isfinite(probs).all()),
        "sums_to_one": (probs.float().sum(-1) - 1).abs().max().item(),
        "vs_float32": same_probs(probs, probs32, CONV_PROB_REL)}
    result["ok"] = (result["finite"] and result["vs_float32"]["ok"]
                    and result["sums_to_one"] < 1e-3
                    and list(probs.shape) == [CONV_BATCH, 400])
    del fn, model, xs
    torch.cuda.empty_cache()
    return result


def profiled_share(fn, iters=2):
    """The device's busy share of ``iters`` calls of ``fn`` under
    torch.profiler and the device time by kind of kernel
    (``profile_slice.op_groups``), per call; "not measured" where the trace
    holds no device event."""
    from torch.profiler import ProfilerActivity, profile

    from focus_tpu_torch.profile_slice import _busy_us, device_rows, op_groups

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / iters
    rows = device_rows(prof)
    if not rows:
        return {"busy_share": "not measured", "wall_ms_per_call": wall_ms}
    busy_ms = _busy_us(prof)[0] / 1e3 / iters
    return {"wall_ms_per_call": wall_ms, "device_busy_ms_per_call": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "device_ms_per_call": sum(r[2] for r in rows) / 1e3 / iters,
            "op_groups": op_groups(rows, iters)}


def finite_grads(model):
    return all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()
               if p.grad is not None)


def slowfast_train():
    """(c) ``slowfast_train_entry(batch=8)``: SGD steps at the 224 train
    crop in bf16 (float32 masters), ms a step by CUDA events (median) in
    NCDHW and channels_last_3d, in turns, train clips/s in the models'
    default layout, peak memory, finite loss and gradients, the busy share
    and the device time by kind under torch.profiler."""
    from focus_tpu_torch.entry import slowfast_train_entry

    fn, (xs, labels) = slowfast_train_entry(device=DEV, batch=CONV_BATCH)
    model = fn.model
    times = {name: [] for name, _ in CONV_FORMATS}
    torch.cuda.reset_peak_memory_stats()
    for name, fmt in CONV_FORMATS + CONV_FORMATS[::-1]:
        model.memory_format = fmt
        times[name].append(time_ms(lambda: fn(xs, labels),
                                   warmup=CONV_TRAIN_WARMUP,
                                   iters=CONV_TRAIN_ITERS))
    peak = torch.cuda.max_memory_allocated() / 1e9
    model.memory_format = type(model).memory_format
    ms = {k: statistics.median(v) for k, v in times.items()}
    default = CONV_FORMAT_NAMES[type(model).memory_format]
    stats = {k: v.item() for k, v in fn(xs, labels).items()}
    result = {"batch": CONV_BATCH, "clips": [list(x.shape) for x in xs],
              "solver": "SGD, Nesterov momentum 0.9, weight decay 1e-4, "
                        "global-norm clip 0.05 (the config defaults'), "
                        "cosine with warm-up from 0.01; head dropout 0.5",
              "default_memory_format": default,
              "ms_per_step": ms[default], "ms_by_format": ms,
              "ms_in_turns": times,
              "train_clips_per_sec": CONV_BATCH / (ms[default] / 1e3),
              "peak_memory_gb": peak, "stats": stats,
              "finite": math.isfinite(stats["loss"])
              and finite_grads(fn.model),
              "profile": profiled_share(lambda: fn(xs, labels))}
    result["ok"] = result["finite"]
    del fn, xs, labels
    torch.cuda.empty_cache()
    return result


def slowfast_card_vs_cpu():
    """(c) One step at batch 2 in float32 (no dropout: the two devices draw
    apart) from the same weights and batch, on the card and on the CPU,
    and the same step in float64 on the card as the exact reference: the
    loss, the running statistics after the step and the whole gradient
    (clipped, as the step leaves it) card against CPU; each gradient within
    CONV_GRAD_REL_L2 relative L2 of the CPU's, or, where the two float32
    gradients of a tensor lie farther apart, the card's within
    CONV_F64_REL_L2 of the float64 one (the train-mode gradients of some
    BatchNorm parameters are ill-conditioned in float32: sums of terms that
    nearly cancel); a gradient that is zero on the CPU, behind a transform's
    zero-init final BatchNorm, is zero on the card."""
    from focus_tpu_torch.engine.trainer import (
        build_supervised_state,
        make_supervised_train_step,
    )
    from focus_tpu_torch.entry import slowfast_cfg, slowfast_inputs
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.models.losses import get_loss_func

    cfg = slowfast_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.MODEL.DROPOUT_RATE = 0.0
    weights = build_model(cfg, "cpu", seed=0).state_dict()
    runs = {}
    for dev, dtype in (("cpu", torch.float32), (DEV, torch.float32),
                       (DEV, torch.float64)):
        # one set of weights: the two devices' generators draw apart
        model = build_model(cfg, dev, seed=0)
        model.load_state_dict(weights)
        model = model.to(dtype)
        model.dtype = dtype
        state = build_supervised_state(cfg, model, 100)
        step = make_supervised_train_step(model, cfg, get_loss_func(cfg))
        xs, labels = slowfast_inputs(cfg, 2, 1, dev, cfg.DATA.TRAIN_CROP_SIZE,
                                     labels=True)
        t0 = time.perf_counter()
        _, stats = step(state, xs, labels, {})
        loss = stats["loss"].item()
        seconds = time.perf_counter() - t0
        runs[dev, dtype] = (
            loss, {n: p.grad.detach().double().cpu()
                   for n, p in model.named_parameters()},
            {k: v.detach().double().cpu()
             for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}, seconds)
        del model, state, step, xs, labels
    torch.cuda.empty_cache()
    (loss_c, g_c, s_c, sec_c), (loss_g, g_g, s_g, sec_g), (_, g64, _, _) = (
        runs["cpu", torch.float32], runs[DEV, torch.float32],
        runs[DEV, torch.float64])

    def rel(a, b):
        return (a - b).norm().item() / b.norm().item()

    compared, over, zero_mismatch = {}, {}, []
    for n, ref in g_c.items():
        if ref.norm().item() == 0.0:
            if g_g[n].abs().max().item() != 0.0:
                zero_mismatch.append(n)
            continue
        compared[n] = rel(g_g[n], ref)
        if compared[n] > CONV_GRAD_REL_L2:
            over[n] = {"card_vs_cpu": compared[n],
                       "card_vs_float64": rel(g_g[n], g64[n]),
                       "cpu_vs_float64": rel(ref, g64[n])}
    stats_err = max((s_g[k] - v).abs().max().item()
                    / max(v.abs().max().item(), 1e-30) for k, v in s_c.items())
    worst = max(compared, key=compared.get)
    whole = math.sqrt(sum((g_g[n] - g_c[n]).pow(2).sum().item() for n in g_c)
                      ) / math.sqrt(sum(g.pow(2).sum().item()
                                        for g in g_c.values()))
    result = {"batch": 2, "dtype": "float32 (TF32 off); float64 on the card "
                                   "as the reference",
              "loss": {"card": loss_g, "cpu": loss_c,
                       "rel_err": abs(loss_g - loss_c) / abs(loss_c)},
              "grads_compared": len(compared),
              "grads_zero_on_both": len(g_c) - len(compared)
              - len(zero_mismatch),
              "grads_zero_on_cpu_alone": zero_mismatch,
              "worst_grad_rel_l2": {"name": worst, "value": compared[worst]},
              "grads_over_rel_l2": over,
              "whole_grad_rel_l2": whole,
              "running_stats_rel_err": stats_err,
              "step_seconds": {"card": sec_g, "cpu": sec_c},
              "tolerances": {"loss_rel": CONV_LOSS_REL,
                             "grad_rel_l2": CONV_GRAD_REL_L2,
                             "grad_rel_l2_to_float64": CONV_F64_REL_L2,
                             "running_stats_rel": CONV_STATS_REL}}
    result["ok"] = (result["loss"]["rel_err"] <= CONV_LOSS_REL
                    and whole <= CONV_GRAD_REL_L2
                    and all(o["card_vs_float64"] <= CONV_F64_REL_L2
                            for o in over.values())
                    and not zero_mismatch and stats_err <= CONV_STATS_REL)
    return result


class KineticsClips:
    """A Kinetics-400 split as the real dataset's modes yield it: each clip
    uint8 frames [T, crop, crop, 3] split into the slow and fast pathways by
    ``datasets/utils.pack_pathway_output``, its label, index and no
    metadata. Train and val clips are a random window and crop (the train
    crop) of one of SOURCES seeded source videos in memory; a test video's
    views are its middle window at each of the three spatial crops
    (``transform.uniform_crop``) of the test crop. No file is read."""

    SOURCES = 4

    def __init__(self, cfg, mode):
        self.cfg, self.mode = cfg, mode
        test = mode == "test"
        self.crop = (cfg.DATA.TEST_CROP_SIZE if test
                     else cfg.DATA.TRAIN_CROP_SIZE)
        self.views = (cfg.TEST.NUM_ENSEMBLE_VIEWS
                      * cfg.TEST.NUM_SPATIAL_CROPS) if test else 1
        self.size = {"train": CONV_TRAIN_CLIPS, "val": CONV_VAL_CLIPS,
                     "test": CONV_TEST_VIDEOS * self.views}[mode]
        T = cfg.DATA.NUM_FRAMES
        rs = np.random.default_rng(cfg.RNG_SEED + 13)
        self.videos = rs.integers(
            0, 256, (self.SOURCES, 2 * T, self.crop, self.crop * 4 // 3, 3),
            dtype=np.uint8)

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        from focus_tpu_torch.datasets import transform as xf
        from focus_tpu_torch.datasets.utils import pack_pathway_output

        cfg, T = self.cfg, self.cfg.DATA.NUM_FRAMES
        video = index // self.views
        source = self.videos[video % self.SOURCES]
        if self.mode == "test":
            frames = xf.uniform_crop(source[T // 2:T // 2 + T], self.crop,
                                     index % cfg.TEST.NUM_SPATIAL_CROPS)
        else:
            rng = np.random.RandomState([cfg.RNG_SEED, index])
            start = rng.randint(0, T + 1)
            frames = xf.random_crop(source[start:start + T], self.crop, rng)
        label = np.int32(video * 7 % cfg.MODEL.NUM_CLASSES)
        return (tuple(pack_pathway_output(cfg, np.ascontiguousarray(frames))),
                label, np.int32(index), {})


@torch.no_grad()
def conv_direct_test(cfg, checkpoint, meter):
    """The test split's clips through ``EvalForward`` on a model loaded
    from ``checkpoint``, in the loader's batches (the last one short, not
    padded), ensembled per video as the meter ensembles them (the sum, or
    the max over views): max |the meter's ensembles - these|. A clip is
    one tensor or a tuple of pathways."""
    from focus_tpu_torch.datasets.build import build_dataset
    from focus_tpu_torch.entry import EvalForward
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.ops.preprocess import device_normalize
    from focus_tpu_torch.utils import checkpoint as cu

    dataset = build_dataset(cfg.TEST.DATASET, cfg, "test")
    model = build_model(cfg, DEV)
    cu.load_checkpoint(checkpoint, model, cfg)
    forward = EvalForward(model)
    views = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    use_max = meter.ensemble_method == "max"
    scores = np.full_like(meter.video_preds, -np.inf if use_max else 0.0)
    bs = cfg.TEST.BATCH_SIZE
    for start in range(0, len(dataset), bs):
        idx = list(range(start, min(start + bs, len(dataset))))
        items = [dataset[i][0] for i in idx]
        if isinstance(items[0], (tuple, list)):
            video = [torch.from_numpy(np.stack([it[p] for it in items]))
                     .to(DEV) for p in range(len(items[0]))]
        else:
            video = torch.from_numpy(np.stack(items)).to(DEV)
        probs = forward(device_normalize(video, cfg)).float().cpu().numpy()
        for row, i in enumerate(idx):
            v = i // views
            scores[v] = (np.maximum(scores[v], probs[row]) if use_max
                         else scores[v] + probs[row])
    del model, forward
    torch.cuda.empty_cache()
    return float(np.abs(meter.video_preds - scores).max())


def slowfast_loops():
    """(d) ``tools.run_net`` on ``configs/Kinetics/SLOWFAST_8x8_R50.yaml``
    over in-script Kinetics splits (``KineticsClips`` as the registry's
    ``Kinetics``): 2 epochs of 4 steps at batch 8, precise BN over 2 batches
    and validation and a checkpoint after each, then the test path from the
    last checkpoint at the 256 crop, 4 videos x 1 view x 3 crops: every clip
    counted once, the checkpoint loaded whole, the ensembles against a
    direct loop; the loop's, validation's and the test's clips/s."""
    from focus_tpu_torch.config.defaults import assert_and_infer_cfg
    from focus_tpu_torch.engine import trainer
    from focus_tpu_torch.tools import run_net
    from focus_tpu_torch.utils.parser import load_config, parse_args

    reductions = {
        "SOLVER.MAX_EPOCH": "2 (196): the cosine schedule over 2 epochs",
        "BN.NUM_BATCHES_PRECISE": f"{CONV_PRECISE_BATCHES} (200)",
        "TRAIN.EVAL_PERIOD": "1 (10)",
        "TRAIN.BATCH_SIZE / TEST.BATCH_SIZE": f"{CONV_BATCH} (64 over "
                                              "NUM_GPUS 8: one card's share)",
        "NUM_GPUS": "1 (8): one card",
        "TEST.NUM_ENSEMBLE_VIEWS": "1 (10)",
        "TRAIN.AUTO_RESUME": "False (True): a fresh output directory",
        "data": f"in-script: {CONV_TRAIN_CLIPS} train, {CONV_VAL_CLIPS} val "
                f"clips, {CONV_TEST_VIDEOS} test videos (Kinetics-400: "
                "240k / 20k / 20k videos, decoded by PyAV, which the card's "
                "machine lacks)"}
    argv = ["--device", DEV, "--cfg",
            os.path.join(KINETICS, "SLOWFAST_8x8_R50.yaml"),
            "TRAIN.METHOD", "sup", "TEST.EVAL_TASK", "ar", "NUM_GPUS", "1",
            "TRAIN.BATCH_SIZE", str(CONV_BATCH),
            "TEST.BATCH_SIZE", str(CONV_BATCH),
            "SOLVER.MAX_EPOCH", "2", "TRAIN.EVAL_PERIOD", "1",
            "BN.NUM_BATCHES_PRECISE", str(CONV_PRECISE_BATCHES),
            "TEST.NUM_ENSEMBLE_VIEWS", "1", "TRAIN.AUTO_RESUME", "False",
            "DATA_LOADER.NUM_WORKERS", "4", "LOG_PERIOD", "1",
            "OUTPUT_DIR", CONV_ENGINE_DIR]
    precise = []
    compute = trainer.compute_precise_bn_stats

    def counted_precise(*args, **kwargs):
        precise.append(compute(*args, **kwargs))
        return precise[-1]

    runs = {"train": [], "test": []}
    trainer.compute_precise_bn_stats = counted_precise
    try:
        with captured_engine(runs), registered_splits(
                {"Kinetics": KineticsClips}):
            t0 = time.perf_counter()
            run_net.main(argv)
            loop_s = time.perf_counter() - t0
            (tr, _, train_peak), = runs["train"]
            (te, _, test_peak), = runs["test"]
            cfg = assert_and_infer_cfg(load_config(parse_args(argv)))
            views = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
            direct = conv_direct_test(cfg, te.checkpoint["path"], te.meter)
    finally:
        trainer.compute_precise_bn_stats = compute
    losses = [x for epoch in tr.losses for x in epoch]
    counted_once = bool((te.meter.clip_count == views).all()
                        and te.meter.seen_clips.sum() == te.clips)
    result = {
        "reductions": reductions,
        "train": {"steps": tr.steps, "clips": tr.clips,
                  "losses": losses,
                  "finite": all(math.isfinite(x) for x in losses),
                  "precise_bn_batches": precise,
                  "val_stats": tr.val_stats, "val_clips": tr.val_clips,
                  "checkpoint_seconds": tr.checkpoint_seconds,
                  "train_loop_clips_per_sec": tr.clips / tr.seconds,
                  "wait_share": tr.wait_seconds / tr.seconds,
                  "val_clips_per_sec": tr.val_clips / tr.val_seconds,
                  "peak_memory_gb": train_peak},
        "test": {"checkpoint": os.path.relpath(te.checkpoint["path"], REPO),
                 "loaded": len(te.checkpoint["loaded"]),
                 "missing": len(te.checkpoint["missing"]),
                 "clips": int(te.clips), "batches": int(te.batches),
                 "every_clip_counted_once": counted_once,
                 "stats": {k: v if isinstance(v, str) else float(v)
                           for k, v in te.stats.items()},
                 "vs_direct_loop": {"max_abs_summed_prob": direct,
                                    "atol": CONV_LOOP_ATOL},
                 "test_loop_clips_per_sec": te.clips / te.seconds,
                 "peak_memory_gb": test_peak},
        "run_net_seconds": loop_s}
    result["ok"] = (result["train"]["finite"] and tr.steps == 8
                    and precise == [CONV_PRECISE_BATCHES] * 2
                    and len(tr.val_stats) == 2
                    and len(tr.checkpoint_seconds) == 2
                    and not te.checkpoint["missing"] and counted_once
                    and direct <= CONV_LOOP_ATOL)
    return result


def depthwise_ms(model, batch):
    """X3D-M's depthwise 3x3x3 convolution of each stage's second block
    (stride 1, as all but the first) at the shape the train crop gives it,
    bf16, in channels_last_3d and NCDHW: ms a call by CUDA events
    (median)."""
    from focus_tpu_torch.models.resnet_helper import conv

    out, T = {}, model.cfg.DATA.NUM_FRAMES
    side = model.cfg.DATA.TRAIN_CROP_SIZE // 4
    for s in (2, 3, 4, 5):
        layer = getattr(model, f"s{s}").pathway0_res1.branch2.b
        c = layer.in_channels
        x = torch.randn(batch, c, T, side, side, device=DEV,
                        dtype=torch.bfloat16)
        row = {"shape": [batch, c, T, side, side],
               "stride": list(layer.stride)}
        for name, fmt in CONV_FORMATS:
            xf = x.contiguous(memory_format=fmt)
            row[f"ms_{name}"] = time_ms(lambda: conv(xf, layer))
        out[f"s{s}"] = row
        side //= 2
    return out


def x3d_m():
    """(e) X3D-M (``configs/Kinetics/X3D_M.yaml``: width factor 2.0, depth
    factor 2.2, 16 frames, bf16) at batch 4: the eval forward at the 256
    test crop against float32 on the same weights, and one SGD step at the
    224 train crop against a float32 copy from the same weights and batch
    (no dropout): loss, the whole gradient's cosine and relative L2;
    forward and step ms by CUDA events, the depthwise convolutions' ms."""
    from focus_tpu_torch.config import get_cfg
    from focus_tpu_torch.engine.trainer import (
        build_supervised_state,
        make_supervised_train_step,
    )
    from focus_tpu_torch.entry import EvalForward
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.models.losses import get_loss_func

    batch = 4
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(KINETICS, "X3D_M.yaml"))
    cfg.MODEL.DROPOUT_RATE = 0.0
    rs = np.random.RandomState(3)
    T = cfg.DATA.NUM_FRAMES

    def clip(crop):
        return torch.from_numpy(rs.rand(batch, T, crop, crop, 3).astype(
            np.float32)).to(DEV)

    model = build_model(cfg, DEV)
    fn = EvalForward(model)
    x_test = clip(cfg.DATA.TEST_CROP_SIZE)
    fwd_ms = time_ms(lambda: fn(x_test), warmup=2, iters=CONV_EVAL_ITERS)
    probs = fn(x_test)
    dtype, model.dtype = model.dtype, torch.float32
    probs32 = fn(x_test)
    model.dtype = dtype
    dw = depthwise_ms(model, batch)
    x_train = clip(cfg.DATA.TRAIN_CROP_SIZE)
    labels = torch.from_numpy(rs.randint(0, 400, batch)).to(DEV)
    runs = {}
    for dtype in ("bfloat16", "float32"):
        cfg.TPU.COMPUTE_DTYPE = dtype
        m = build_model(cfg, DEV)
        state = build_supervised_state(cfg, m, 100)
        step = make_supervised_train_step(m, cfg, get_loss_func(cfg))
        _, stats = step(state, x_train, labels, {})
        runs[dtype] = (stats["loss"].item(), torch.cat(
            [p.grad.flatten().double() for p in m.parameters()]))
        if dtype == "bfloat16":
            step_ms = time_ms(lambda: step(state, x_train, labels, {}),
                              warmup=1, iters=CONV_TRAIN_ITERS)
        del m, state, step
    (lb, gb), (lf, gf) = runs["bfloat16"], runs["float32"]
    cos = float(torch.dot(gb, gf) / (gb.norm() * gf.norm()))
    result = {"model": "X3D-M (configs/Kinetics/X3D_M.yaml), 400 classes",
              "batch": batch, "forward_ms": fwd_ms,
              "clips_per_sec": batch / (fwd_ms / 1e3),
              "step_ms": step_ms,
              "train_clips_per_sec": batch / (step_ms / 1e3),
              "forward_vs_float32": same_probs(probs, probs32, CONV_PROB_REL),
              "step_vs_float32": {
                  "loss": [lb, lf], "loss_rel_err": abs(lb - lf) / abs(lf),
                  "grad_cosine": cos,
                  "grad_rel_l2": float((gb - gf).norm() / gf.norm())},
              "depthwise_conv_ms": dw,
              "tolerances": {"prob_rel": CONV_PROB_REL,
                             "loss_rel": CONV_BF16_LOSS_REL,
                             "grad_cosine": CONV_BF16_GRAD_COS}}
    result["ok"] = (result["forward_vs_float32"]["ok"]
                    and result["step_vs_float32"]["loss_rel_err"]
                    <= CONV_BF16_LOSS_REL and cos >= CONV_BF16_GRAD_COS)
    del model, fn
    torch.cuda.empty_cache()
    return result


def phase_conv_family(smi):
    """Phase 16: the ResNet video family on the card. (a) the four
    reference fixtures in float32 (CONV_FIXTURE_ATOL); (b) SlowFast 8x8
    R50's eval forward at batch 8; (c) its train step at batch 8, and at
    batch 2 in float32 the card against the CPU; (d) the train and test
    loops through ``tools.run_net``; (e) X3D-M's forward and step against
    float32. No hand-written kernel runs here, so no launch is counted."""
    from focus_tpu_torch.utils import logging as port_logging

    shutil.rmtree(CONV_ENGINE_DIR, ignore_errors=True)
    result = {"phase": "conv_family", "gpu": smi}
    t0 = time.perf_counter()
    try:
        errs = conv_fixtures()
        result["fixtures"] = {"max_abs_err": errs, "atol": CONV_FIXTURE_ATOL,
                              "ok": all(e <= CONV_FIXTURE_ATOL
                                        for e in errs.values())}
        result["slowfast_eval"] = slowfast_eval()
        result["slowfast_train"] = slowfast_train()
        result["slowfast_card_vs_cpu"] = slowfast_card_vs_cpu()
        with open(CONV_ENGINE_LOG, "w") as log, contextlib.redirect_stdout(
                log):
            result["slowfast_loops"] = slowfast_loops()
        result["x3d_m"] = x3d_m()
    finally:
        port_logging.close_logging()
        shutil.rmtree(CONV_ENGINE_DIR, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t0
    parts = [v for v in result.values() if isinstance(v, dict) and "ok" in v]
    result["ok"] = len(parts) == 6 and all(v["ok"] for v in parts)
    emit(result)
    if not result["ok"]:
        raise AssertionError(
            "conv family phase failed: "
            f"{sorted(k for k, v in result.items() if isinstance(v, dict) and not v.get('ok', True))}")


MVIT_ENGINE_DIR = os.path.join(REPO, "build", "mvit_engine")
MVIT_ENGINE_LOG = os.path.join(REPO, "build", "mvit_engine.log")
MVIT_YAMLS = ("Kinetics/MVIT_B_16x4_CONV.yaml",
              "Kinetics/MVIT_B_32x3_CONV.yaml",
              "Kinetics/pytorchvideo/MVIT_B_16x4_CONV.yaml",
              "ImageNet/MVIT_B_16_CONV.yaml", "AVA/MVIT_16X4.yaml")
MVIT_FIXTURE_ATOL = 1e-4  # tests/test_full_model_golden.py's
MVIT_ATTN_FIXTURE_ATOL = 3e-5  # tests/test_golden_parity.py's
MVIT_BATCH = 8  # the yaml's TEST.BATCH_SIZE 64 over NUM_GPUS 8
MVIT_EVAL_ITERS = 10
MVIT_TRAIN_WARMUP, MVIT_TRAIN_ITERS = 2, 5
# bf16 against float32 on the same weights and clip: each probability
# within this share of the largest (as phase 16)
MVIT_PROB_REL = 0.05
# the W8A8 forward against the bf16 one, as tests/test_int8_serving.py's
# test_int8_mvit_runs_and_reuses_params holds JAX's (absolute)
MVIT_INT8_ATOL = 0.05
# the float32 step at batch 2, the card against the CPU (as phase 16)
MVIT_LOSS_REL = 1e-4
MVIT_GRAD_REL_L2 = 1e-3
MVIT_F64_REL_L2 = 1e-2
MVIT_CMP_BATCH = 2
MVIT_EXACT_ZERO_GRADS = ("attn.norm_k.bias",)
# the depthwise pooling convolutions of MViT-B at batch 8: (where, input
# [N, C, T, H, W], stride)
MVIT_POOL_CONVS = (("block 0 k and v", (8, 96, 8, 56, 56), (1, 8, 8)),
                   ("block 1 q", (16, 96, 8, 56, 56), (1, 2, 2)),
                   ("blocks 4-13 k and v", (32, 96, 8, 14, 14), (1, 1, 1)))


def mvit_fixture_cfg():
    """``tests/test_full_model_golden.py::test_mvit_full_golden``'s config:
    D=24 over 4 blocks, 4 frames, the 64 crop, float32."""
    from focus_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.MODEL_NAME, cfg.MODEL.ARCH = "MViT", "mvit"
    cfg.MODEL.NUM_CLASSES = 7
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 64
    cfg.MVIT.EMBED_DIM, cfg.MVIT.NUM_HEADS, cfg.MVIT.DEPTH = 24, 2, 4
    cfg.MVIT.DIM_MUL = cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MVIT.POOL_Q_STRIDE = [[1, 1, 2, 2]]
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
    cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 4, 4]
    cfg.MVIT.PATCH_PADDING = [1, 3, 3]
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


@torch.no_grad()
def mvit_fixtures():
    """(a) ``mvit_full.npz`` and ``multiscale_attention.npz`` of the
    executed reference on the card in float32 (TF32 off since the build
    phase), their state dicts loaded by name: max |err| of each."""
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.models.mvit import MultiScaleAttention

    def load(name):
        d = dict(np.load(os.path.join(REPO, "tests", "fixtures",
                                      f"{name}.npz")))
        return d, {k[3:]: torch.from_numpy(v) for k, v in d.items()
                   if k.startswith("sd/")}

    d, sd = load("mvit_full")
    model = build_model(mvit_fixture_cfg(), DEV)
    model.load_state_dict(sd, strict=True)
    out = model(torch.from_numpy(d["video"].transpose(0, 2, 3, 4, 1).copy()
                                 ).to(DEV))
    errs = {"mvit_full": (out.cpu() - torch.from_numpy(d["out"])).abs().max()
            .item()}
    d, sd = load("multiscale_attention")
    attn = MultiScaleAttention(
        d["x"].shape[-1], int(d["num_heads"]), qkv_bias=True,
        kernel_q=(1, 3, 3), kernel_kv=(1, 3, 3), stride_q=(1, 1, 1),
        stride_kv=(1, 2, 2)).to(DEV)
    attn.load_state_dict(sd, strict=True)
    out, thw = attn(torch.from_numpy(d["x"]).to(DEV), tuple(d["thw"]))
    errs["multiscale_attention"] = (out.cpu() - torch.from_numpy(d["out"])
                                    ).abs().max().item()
    atol = {"mvit_full": MVIT_FIXTURE_ATOL,
            "multiscale_attention": MVIT_ATTN_FIXTURE_ATOL}
    return {"max_abs_err": errs, "atol": atol,
            "ok": all(errs[k] <= atol[k] for k in errs)
            and list(thw) == list(d["out_thw"])}


def mvit_eval():
    """(b) ``mvit_entry(batch=8)``: MViT-B 16x4's eval forward at the 224
    crop in bf16, ms by CUDA events (median), clips/s, peak memory, the
    device's busy share and time by kind under torch.profiler; the
    probabilities against float32 on the same weights and clip; the W8A8
    model (``int8=True``, the same weights) timed and held to the bf16
    probabilities."""
    from focus_tpu_torch.entry import mvit_entry

    fn, (video,) = mvit_entry(device=DEV, batch=MVIT_BATCH)
    model = fn.model
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: fn(video), warmup=2, iters=MVIT_EVAL_ITERS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    probs = fn(video)
    dtype, model.dtype = model.dtype, torch.float32
    probs32 = fn(video)
    model.dtype = dtype
    profile = profiled_share(lambda: fn(video))
    fn8, _ = mvit_entry(device=DEV, batch=MVIT_BATCH, int8=True)
    fn8.model.load_state_dict(model.state_dict(), strict=True)
    ms8 = time_ms(lambda: fn8(video), warmup=2, iters=MVIT_EVAL_ITERS)
    probs8 = fn8(video)
    int8_err = (probs8.float() - probs.float()).abs().max().item()
    result = {
        "model": "MViT-B 16x4, Kinetics-400 (configs/Kinetics/"
                 "MVIT_B_16x4_CONV.yaml), bf16, the JAX package's "
                 "initialisers (seed 0)",
        "clip": list(video.shape), "batch": MVIT_BATCH,
        "ms": ms, "clips_per_sec": MVIT_BATCH / (ms / 1e3),
        "peak_memory_gb": peak, "profile": profile,
        "probs_shape": list(probs.shape),
        "finite": bool(torch.isfinite(probs).all()),
        "sums_to_one": (probs.float().sum(-1) - 1).abs().max().item(),
        "vs_float32": same_probs(probs, probs32, MVIT_PROB_REL),
        "w8a8": {"ms": ms8, "clips_per_sec": MVIT_BATCH / (ms8 / 1e3),
                 "max_abs_err_vs_bf16": int8_err, "atol": MVIT_INT8_ATOL,
                 "top1_agreement": (probs8.argmax(-1) == probs.argmax(-1))
                 .float().mean().item(),
                 "finite": bool(torch.isfinite(probs8).all())}}
    result["ok"] = (result["finite"] and result["vs_float32"]["ok"]
                    and result["sums_to_one"] < 1e-3
                    and list(probs.shape) == [MVIT_BATCH, 400]
                    and result["w8a8"]["finite"]
                    and int8_err <= MVIT_INT8_ATOL)
    del fn, fn8, model, video
    torch.cuda.empty_cache()
    return result


def mvit_pool_conv_ms():
    """The depthwise 3x3x3 pooling convolution (bf16, groups = head dim 96)
    at three of MViT-B's shapes: ms a call by CUDA events (median) on the
    tokens' channels-last view [N, C, T, H, W] of [N, T, H, W, C], on a
    dense NCDHW copy of it, and the copy and the convolution together (what
    ``attention_pool`` runs), in turns."""
    import torch.nn.functional as F

    out = {}
    w = torch.randn(96, 1, 3, 3, 3, device=DEV, dtype=torch.bfloat16)
    for where, (n, c, t, h, wd), stride in MVIT_POOL_CONVS:
        view = torch.randn(n, t, h, wd, c, device=DEV,
                           dtype=torch.bfloat16).permute(0, 4, 1, 2, 3)
        dense = view.contiguous()

        def conv(x):
            return F.conv3d(x, w, None, stride, 1, groups=c)

        fns = {"channels_last_view": lambda: conv(view),
               "ncdhw": lambda: conv(dense),
               "copy_then_ncdhw": lambda: conv(view.contiguous())}
        times = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            times[k].append(time_ms(fns[k], warmup=2, iters=10))
        out[where] = {"input": [n, c, t, h, wd], "stride": list(stride),
                      "ms": {k: statistics.median(v)
                             for k, v in times.items()},
                      "ms_in_turns": times}
    return out


def mvit_train():
    """(c) ``mvit_train_entry(batch=8)``: AdamW steps at the 224 crop in
    bf16 (float32 masters) under the yaml's mixup / CutMix, soft-target
    loss, head dropout and drop path: ms a step by CUDA events (median),
    train clips/s, peak memory, finite loss and gradients, the busy share
    and the device time by kind under torch.profiler."""
    from focus_tpu_torch.entry import mvit_train_entry

    fn, (video, labels) = mvit_train_entry(device=DEV, batch=MVIT_BATCH)
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: fn(video, labels), warmup=MVIT_TRAIN_WARMUP,
                 iters=MVIT_TRAIN_ITERS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    stats = {k: v.item() for k, v in fn(video, labels).items()}
    result = {"batch": MVIT_BATCH, "clip": list(video.shape),
              "solver": "AdamW, weight decay 0.05 off the 1-D parameters, "
                        "global-norm clip 1.0, cosine after 30 warm-up "
                        "epochs; mixup 0.8 / CutMix 1.0 with label "
                        "smoothing 0.1, soft-target cross-entropy; head "
                        "dropout 0.5, drop path to 0.2",
              "ms_per_step": ms,
              "train_clips_per_sec": MVIT_BATCH / (ms / 1e3),
              "peak_memory_gb": peak, "stats": stats,
              "finite": math.isfinite(stats["loss"])
              and finite_grads(fn.model),
              "profile": profiled_share(lambda: fn(video, labels))}
    result["ok"] = result["finite"]
    del fn, video, labels
    torch.cuda.empty_cache()
    return result


def mvit_card_vs_cpu():
    """(c) One step at batch 2 in float32 (no mixup, dropout or drop path:
    the two devices draw apart; label-smoothed one-hot targets through the
    yaml's soft-target loss) from the same weights and batch, on the card
    and on the CPU, and the same step in float64 on the card (attention
    logits float32, as the model takes them) as the exact reference: the
    loss and the whole gradient (clipped, as the step leaves it) card
    against CPU; each gradient within MVIT_GRAD_REL_L2 relative L2 of the
    CPU's, or, where the two float32 gradients of a tensor lie farther
    apart, the card's within MVIT_F64_REL_L2 of the float64 one. The keys'
    LayerNorm biases have a gradient of zero in exact arithmetic (each adds
    one constant to a query's logits, which the softmax removes): what the
    three steps give there is rounding, so the card's is held to
    MVIT_GRAD_REL_L2 of the whole gradient's norm instead."""
    from focus_tpu_torch.engine.trainer import (
        build_supervised_state,
        make_supervised_train_step,
    )
    from focus_tpu_torch.entry import mvit_cfg, mvit_inputs
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.models.losses import get_loss_func

    cfg = mvit_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.MODEL.DROPOUT_RATE = cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.MIXUP.ENABLE = False
    weights = build_model(cfg, "cpu", seed=0).state_dict()
    n = cfg.MODEL.NUM_CLASSES
    runs = {}
    for dev, dtype in (("cpu", torch.float32), (DEV, torch.float32),
                       (DEV, torch.float64)):
        model = build_model(cfg, dev, seed=0)
        model.load_state_dict(weights)
        model = model.to(dtype)
        model.dtype = dtype
        state = build_supervised_state(cfg, model, 100)
        step = make_supervised_train_step(model, cfg, get_loss_func(cfg))
        video, labels = mvit_inputs(cfg, MVIT_CMP_BATCH, 1, dev, labels=True)
        soft = torch.nn.functional.one_hot(labels, n).float() * 0.9 + 0.1 / n
        t0 = time.perf_counter()
        _, stats = step(state, video, soft, {})
        loss = stats["loss"].item()
        seconds = time.perf_counter() - t0
        runs[dev, dtype] = (loss, {k: p.grad.detach().double().cpu()
                                   for k, p in model.named_parameters()},
                            seconds)
        del model, state, step, video, labels
    torch.cuda.empty_cache()
    (loss_c, g_c, sec_c), (loss_g, g_g, sec_g), (_, g64, _) = (
        runs["cpu", torch.float32], runs[DEV, torch.float32],
        runs[DEV, torch.float64])

    def rel(a, b):
        return (a - b).norm().item() / max(b.norm().item(), 1e-30)

    whole_norm = math.sqrt(sum(g.pow(2).sum().item() for g in g_c.values()))
    compared, over, zero, exact_zero = {}, {}, [], {}
    for k, ref in g_c.items():
        if ref.norm().item() == 0.0:
            zero.append(k)
            continue
        if k.endswith(MVIT_EXACT_ZERO_GRADS):
            exact_zero[k] = {"card": g_g[k].norm().item() / whole_norm,
                             "cpu": ref.norm().item() / whole_norm,
                             "float64": g64[k].norm().item() / whole_norm}
            continue
        compared[k] = rel(g_g[k], ref)
        if compared[k] > MVIT_GRAD_REL_L2:
            over[k] = {"card_vs_cpu": compared[k],
                       "card_vs_float64": rel(g_g[k], g64[k]),
                       "cpu_vs_float64": rel(ref, g64[k])}
    worst = max(compared, key=compared.get)
    whole = math.sqrt(sum((g_g[k] - g_c[k]).pow(2).sum().item()
                          for k in g_c)) / whole_norm
    result = {"batch": MVIT_CMP_BATCH,
              "dtype": "float32 (TF32 off); float64 on the card as the "
                       "reference",
              "loss": {"card": loss_g, "cpu": loss_c,
                       "rel_err": abs(loss_g - loss_c) / abs(loss_c)},
              "grads_compared": len(compared), "grads_zero_on_cpu": zero,
              "worst_grad_rel_l2": {"name": worst, "value": compared[worst]},
              "grads_over_rel_l2": over, "whole_grad_rel_l2": whole,
              "exact_zero_grads_over_whole_norm": exact_zero,
              "step_seconds": {"card": sec_g, "cpu": sec_c},
              "tolerances": {"loss_rel": MVIT_LOSS_REL,
                             "grad_rel_l2": MVIT_GRAD_REL_L2,
                             "grad_rel_l2_to_float64": MVIT_F64_REL_L2}}
    result["ok"] = (result["loss"]["rel_err"] <= MVIT_LOSS_REL
                    and whole <= MVIT_GRAD_REL_L2
                    and all(o["card_vs_float64"] <= MVIT_F64_REL_L2
                            for o in over.values())
                    and all(z["card"] <= MVIT_GRAD_REL_L2
                            for z in exact_zero.values()))
    return result


def mvit_loops():
    """(d) ``tools.run_net`` on ``configs/Kinetics/MVIT_B_16x4_CONV.yaml``
    over in-script Kinetics splits (``KineticsClips``, one pathway): 2
    epochs of 4 steps at batch 8 with mixup, validation after each and the
    yaml's checkpoint at the last, then the test path from it: every clip
    counted once, the checkpoint loaded whole, the ensembles against a
    direct loop; the loop's, validation's and the test's clips/s."""
    from focus_tpu_torch.config.defaults import assert_and_infer_cfg
    from focus_tpu_torch.tools import run_net
    from focus_tpu_torch.utils.parser import load_config, parse_args

    reductions = {
        "SOLVER.MAX_EPOCH": "2 (200): the schedule over 2 epochs, inside "
                            "its 30 warm-up epochs",
        "TRAIN.EVAL_PERIOD": "1 (10)",
        "TRAIN.BATCH_SIZE / TEST.BATCH_SIZE": f"{MVIT_BATCH} ({MVIT_BATCH} "
                                              "is 4 x the yaml's 16 over "
                                              "NUM_GPUS 8; 64 over 8)",
        "NUM_GPUS": "1 (8): one card",
        "AUG.NUM_SAMPLE": "1 (2): repeated augmentation waits for the "
                          "Kinetics data slice",
        "AUG.ENABLE": "True, but the in-script clips apply no RandAugment "
                      "or random erasing (the Kinetics dataset's host "
                      "transforms); mixup / CutMix run in the step",
        "TEST.NUM_ENSEMBLE_VIEWS": "1 (10)",
        "TRAIN.AUTO_RESUME": "False (True): a fresh output directory",
        "data": f"in-script: {CONV_TRAIN_CLIPS} train, {CONV_VAL_CLIPS} val "
                f"clips, {CONV_TEST_VIDEOS} test videos (Kinetics-400: "
                "240k / 20k / 20k videos, decoded by PyAV, which the card's "
                "machine lacks)"}
    argv = ["--device", DEV, "--cfg",
            os.path.join(KINETICS, "MVIT_B_16x4_CONV.yaml"),
            "TRAIN.METHOD", "sup", "TEST.EVAL_TASK", "ar", "NUM_GPUS", "1",
            "TRAIN.BATCH_SIZE", str(MVIT_BATCH),
            "TEST.BATCH_SIZE", str(MVIT_BATCH), "AUG.NUM_SAMPLE", "1",
            "SOLVER.MAX_EPOCH", "2", "TRAIN.EVAL_PERIOD", "1",
            "TEST.NUM_ENSEMBLE_VIEWS", "1", "TRAIN.AUTO_RESUME", "False",
            "DATA_LOADER.NUM_WORKERS", "4", "LOG_PERIOD", "1",
            "OUTPUT_DIR", MVIT_ENGINE_DIR]
    runs = {"train": [], "test": []}
    with captured_engine(runs), registered_splits(
            {"Kinetics": KineticsClips}):
        t0 = time.perf_counter()
        run_net.main(argv)
        loop_s = time.perf_counter() - t0
        (tr, _, train_peak), = runs["train"]
        (te, _, test_peak), = runs["test"]
        cfg = assert_and_infer_cfg(load_config(parse_args(argv)))
        views = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        direct = conv_direct_test(cfg, te.checkpoint["path"], te.meter)
    losses = [x for epoch in tr.losses for x in epoch]
    counted_once = bool((te.meter.clip_count == views).all()
                        and te.meter.seen_clips.sum() == te.clips)
    result = {
        "reductions": reductions,
        "train": {"steps": tr.steps, "clips": tr.clips, "losses": losses,
                  "finite": all(math.isfinite(x) for x in losses),
                  "val_stats": tr.val_stats, "val_clips": tr.val_clips,
                  "checkpoint_seconds": tr.checkpoint_seconds,
                  "train_loop_clips_per_sec": tr.clips / tr.seconds,
                  "wait_share": tr.wait_seconds / tr.seconds,
                  "val_clips_per_sec": tr.val_clips / tr.val_seconds,
                  "peak_memory_gb": train_peak},
        "test": {"checkpoint": os.path.relpath(te.checkpoint["path"], REPO),
                 "loaded": len(te.checkpoint["loaded"]),
                 "missing": len(te.checkpoint["missing"]),
                 "clips": int(te.clips), "batches": int(te.batches),
                 "every_clip_counted_once": counted_once,
                 "stats": {k: v if isinstance(v, str) else float(v)
                           for k, v in te.stats.items()},
                 "vs_direct_loop": {"max_abs_summed_prob": direct,
                                    "atol": CONV_LOOP_ATOL},
                 "test_loop_clips_per_sec": te.clips / te.seconds,
                 "peak_memory_gb": test_peak},
        "run_net_seconds": loop_s}
    result["ok"] = (result["train"]["finite"] and tr.steps == 8
                    and len(tr.val_stats) == 2
                    and len(tr.checkpoint_seconds) == 1
                    and not te.checkpoint["missing"] and counted_once
                    and direct <= CONV_LOOP_ATOL)
    return result


@torch.no_grad()
def mvit_yamls():
    """(e) Every MViT yaml built on the card at its own architecture and
    width (bf16) and run once on a clip of its frames at its 224 crop:
    finite outputs of the head's shape (AVA's per box); then an ORViT
    block beside MViT-B's fifth (384 wide, 4 heads of 96: an added block
    needs one that keeps its grid and width) refusing on the card with the
    trajectory kernel's operand check, no kernel launched."""
    from focus_tpu_torch.config import get_cfg
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.ops import trajectory_block as tb

    rows = {}
    for rel in MVIT_YAMLS:
        cfg = get_cfg()
        cfg.merge_from_file(os.path.join(REPO, "configs", rel))
        model = build_model(cfg, DEV)
        crop, T = cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.NUM_FRAMES
        x = torch.rand(1, T, crop, crop, 3, device=DEV)
        boxes = torch.tensor([[[20.0, 30.0, 150.0, 200.0]]], device=DEV)
        out = model(x, bboxes=boxes) if cfg.DETECTION.ENABLE else model(x)
        want = ([1, 1, cfg.MODEL.NUM_CLASSES] if cfg.DETECTION.ENABLE
                else [1, cfg.MODEL.NUM_CLASSES])
        rows[rel] = {"model": type(model).__name__,
                     "name": cfg.MODEL.MODEL_NAME,
                     "params_m": sum(p.numel() for p in model.parameters())
                     / 1e6, "clip": [1, T, crop, crop, 3],
                     "out_shape": list(out.shape),
                     "ok": list(out.shape) == want
                     and bool(torch.isfinite(out).all())}
        del model
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(KINETICS, "MVIT_B_16x4_CONV.yaml"))
    cfg.ORVIT.ENABLE, cfg.ORVIT.ADD_LAYERS, cfg.ORVIT.O = True, [4], 4
    model = build_model(cfg, DEV)
    boxes = torch.rand(1, cfg.DATA.NUM_FRAMES, 4, 4, device=DEV) * 0.4 + 0.3
    before = tb.LAUNCHES
    try:
        crop = cfg.DATA.TRAIN_CROP_SIZE
        model(torch.rand(1, cfg.DATA.NUM_FRAMES, crop, crop, 3, device=DEV),
              {"orvit_bboxes": boxes})
        refusal = "no error"
    except ValueError as e:
        refusal = str(e)
    orvit = {"head_dim": 96, "refusal": refusal,
             "launches": tb.LAUNCHES - before,
             "ok": "head dim 64" in refusal and tb.LAUNCHES == before}
    del model
    torch.cuda.empty_cache()
    return {"yamls": rows, "orvit_head_dim_96": orvit,
            "ok": all(r["ok"] for r in rows.values()) and orvit["ok"]}


def phase_mvit(smi):
    """Phase 17: MViT on the card. (a) the two reference fixtures in
    float32; (b) MViT-B 16x4's eval forward at batch 8 (and its W8A8
    form); (c) its train step at batch 8, and at batch 2 in float32 the
    card against the CPU; (d) the train and test loops through
    ``tools.run_net``; (e) every MViT yaml built and run, and ORViT at head
    dim 96 refused. No hand-written kernel runs on this path (the
    attention is two matmuls, the stem and pooling ``F.conv3d``), so no
    launch is counted."""
    from focus_tpu_torch.utils import logging as port_logging

    shutil.rmtree(MVIT_ENGINE_DIR, ignore_errors=True)
    result = {"phase": "mvit", "gpu": smi}
    t0 = time.perf_counter()
    try:
        result["fixtures"] = mvit_fixtures()
        result["pool_conv_ms"] = mvit_pool_conv_ms()
        result["mvit_eval"] = mvit_eval()
        result["mvit_train"] = mvit_train()
        result["mvit_card_vs_cpu"] = mvit_card_vs_cpu()
        with open(MVIT_ENGINE_LOG, "w") as log, contextlib.redirect_stdout(
                log):
            result["mvit_loops"] = mvit_loops()
        result["mvit_yamls"] = mvit_yamls()
    finally:
        port_logging.close_logging()
        shutil.rmtree(MVIT_ENGINE_DIR, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t0
    parts = [v for v in result.values() if isinstance(v, dict) and "ok" in v]
    result["ok"] = len(parts) == 6 and all(v["ok"] for v in parts)
    emit(result)
    if not result["ok"]:
        failed = sorted(k for k, v in result.items()
                        if isinstance(v, dict) and not v.get("ok", True))
        raise AssertionError(f"MViT phase failed: {failed}")


# ---- phase 18: the datasets' host side behind the card ----------------------

DATA_ENGINE_DIR = os.path.join(REPO, "build", "data_engine")
DATA_ENGINE_LOG = os.path.join(REPO, "build", "data_engine.log")
DATA_SOURCE_VIDEOS = 4  # Kinetics source videos in memory
DATA_VIDEO_FRAMES = 300  # each 10 s at 30 fps
DATA_FRAME = (256, 340)  # Kinetics' and Charades' frames: short side 256
DATA_IMAGE = (375, 500)  # an ImageNet image
DATA_BANK_FRAMES = 160  # Charades frames in memory, cycled over the videos
DATA_CHARADES_FRAMES = 150  # frames of a Charades video
DATA_IMAGES = 8  # ImageNet images in memory, cycled over the files
DATA_HOST_ITEMS = 4  # items a dataset's __getitem__ is timed over
DATA_LOOP_ATOL = 1e-3  # test ensembles against a direct loop (phase 13's)
# The train loop against the direct step loop on its batches, which the
# card's nondeterministic backward (max_pool3d's atomic scatter in MViT's
# pooled skip) keeps from bit-equality; the direct loop run twice shows the
# same spread. Gates: the first step's loss bit-equal (same weights, same
# batch), phase 14's TRAIN_LOOP_LOSS_REL and TRAIN_LOOP_PARAM_REL, and the
# update |loop - direct| / |direct - initial| (relative L2 over the
# parameters) within this share: one step missed or applied twice moves it
# by ~1 / steps (1/8, 1/4); MViT on Kinetics reads ~1e-2, the others less.
DATA_LOOP_UPDATE_REL = 0.05
DATA_YAMLS = {"kinetics": "Kinetics/MVIT_B_16x4_CONV.yaml",
              "charades": "Charades/SLOWFAST_16x8_R50.yaml",
              "imagenet": "ImageNet/MVIT_B_16_CONV.yaml"}


def _file_number(path):
    """The last run of digits in ``path``'s base name (0 if none)."""
    digits = re.findall(r"\d+", os.path.basename(path))
    return int(digits[-1]) if digits else 0


class InScriptReaders:
    """The one substitution of phase 18: the datasets' three file readers
    (cv2 for videos, PIL for frames and images; the checkout holds no
    Kinetics, Charades or ImageNet files) return in-script uint8 data of
    the real data's sizes, a function of the file name alone. Kinetics' ``decoder.decode`` places and samples the clip in
    a 300-frame 256 x 340 video with the port's own ``get_start_end_idx``
    and ``temporal_sampling``, as its whole-file path does (30 fps);
    Charades' ``retry_load_images`` returns 256 x 340 frames and ImageNet's
    ``read_image`` 375 x 500 images. Every read adds its seconds to
    ``seconds``, so a dataset's host time can be read without its reads.
    Everything after the read runs as shipped."""

    def __init__(self, seed=0):
        import threading

        rs = np.random.default_rng(seed)
        self.videos = rs.integers(
            0, 256, (DATA_SOURCE_VIDEOS, DATA_VIDEO_FRAMES, *DATA_FRAME, 3),
            dtype=np.uint8)
        self.frames = rs.integers(0, 256, (DATA_BANK_FRAMES, *DATA_FRAME, 3),
                                  dtype=np.uint8)
        self.images = rs.integers(0, 256, (DATA_IMAGES, *DATA_IMAGE, 3),
                                  dtype=np.uint8)
        self.lock = threading.Lock()
        self.seconds = 0.0

    def _timed(self, read):
        t0 = time.perf_counter()
        out = read()
        with self.lock:
            self.seconds += time.perf_counter() - t0
        return out

    def decode(self, path, sampling_rate, num_frames, clip_idx=-1,
               num_clips=10, target_fps=30, rng=None, selective=True,
               use_offset=False):
        from focus_tpu_torch.datasets import decoder

        def read():
            frames = self.videos[_file_number(path) % DATA_SOURCE_VIDEOS]
            clip_size = sampling_rate * num_frames / target_fps * 30.0
            start, end = decoder.get_start_end_idx(
                len(frames), clip_size, clip_idx, num_clips, rng,
                use_offset=use_offset)
            return decoder.temporal_sampling(frames, start, end, num_frames)

        return self._timed(read)

    def load_images(self, paths, retry=10):
        return self._timed(lambda: [
            self.frames[(37 * _file_number(os.path.dirname(p))
                         + _file_number(p)) % DATA_BANK_FRAMES]
            for p in paths])

    def read_image(self, path):
        return self._timed(
            lambda: self.images[_file_number(path) % DATA_IMAGES])

    @contextlib.contextmanager
    def installed(self):
        from focus_tpu_torch.datasets import charades, decoder
        from focus_tpu_torch.datasets import utils as data_utils

        saved = (decoder.decode, data_utils.retry_load_images,
                 charades.read_image)
        decoder.decode = self.decode
        data_utils.retry_load_images = self.load_images
        charades.read_image = self.read_image
        try:
            yield self
        finally:
            (decoder.decode, data_utils.retry_load_images,
             charades.read_image) = saved


DATA_SPLITS = {  # videos (images) a split lists
    "kinetics": {"train": 16, "val": 8, "test": 4},
    "charades": {"train": 16, "val": 4},  # test reads val
    "imagenet": {"train": 128, "val": 32},
}


def write_data_lists(root):
    """The lists the real datasets read, under ``root``: Kinetics'
    ``{train,val,test}.csv`` (``vid<k>.mp4 <label>``), Charades'
    ``{train,val}.csv`` frame lists (150 frames a video, each frame's
    labels 0-2 of the 157 classes, some runs of frames unlabelled) and
    ImageNet's ``{train,val}/<class>/`` files (8 classes), every file
    empty: the substituted readers map each name to their data."""
    rs = np.random.RandomState(11)
    kin = os.path.join(root, "kinetics")
    os.makedirs(kin)
    for split, n in DATA_SPLITS["kinetics"].items():
        offset = {"train": 0, "val": 100, "test": 200}[split]
        with open(os.path.join(kin, f"{split}.csv"), "w") as f:
            f.write("".join(f"vid{offset + k}.mp4 {(offset + k) * 7 % 400}\n"
                            for k in range(n)))
    cha = os.path.join(root, "charades")
    os.makedirs(cha)
    for split, n in DATA_SPLITS["charades"].items():
        rows = ["original_vido_id video_id frame_id path labels"]
        for v in range(n):
            name = f"{split}{v}"
            actions = rs.randint(0, 157, 3)
            for t in range(DATA_CHARADES_FRAMES):
                labels = sorted(set(actions[:rs.randint(0, 3)])) if (
                    t // 30) % 2 == 0 else []
                text = ('"' + ",".join(map(str, labels)) + '"' if labels
                        else '""')
                rows.append(f"{name} {v} {t} {name}/{name}-{t + 1:06d}.jpg "
                            f"{text}")
        with open(os.path.join(cha, f"{split}.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    img = os.path.join(root, "imagenet")
    for split, n in DATA_SPLITS["imagenet"].items():
        for k in range(n):
            d = os.path.join(img, split, f"n{k % 8:08d}")
            os.makedirs(d, exist_ok=True)
            open(os.path.join(d, f"img_{k}.JPEG"), "w").close()
    return {"kinetics": kin, "charades": cha, "imagenet": img}


@contextlib.contextmanager
def recorded_tools(runs, steps, precise):
    """``tools.train_net`` and ``tools.test_net`` as shipped, each run
    ``counted`` (its TrainRun / TestRun, launches, peak GB appended to
    ``runs``); every train step's batch as the step received it (a copy
    on the device) appended to ``steps``; precise BN's (batches, seconds)
    to ``precise``."""
    from focus_tpu_torch.engine import tester, trainer
    from focus_tpu_torch.tools import test_net, train_net

    saved = (train_net.train, test_net.test,
             trainer.make_supervised_train_step,
             trainer.compute_precise_bn_stats)
    make, compute = saved[2], saved[3]

    def counted_train(cfg, device="cuda"):
        runs["train"].append(counted(lambda: trainer.run_train(cfg, device)))
        return runs["train"][-1][0].state

    def counted_test(cfg, device="cuda"):
        runs["test"].append(counted(lambda: tester.run_test(cfg, device)))
        return runs["test"][-1][0].stats

    def recording_make(model, cfg, loss_fn):
        step = make(model, cfg, loss_fn)

        def recorded_step(state, video, labels, metadata):
            copy = ([v.clone() for v in video]
                    if isinstance(video, (tuple, list)) else video.clone())
            steps.append((copy, labels.clone(), metadata))
            return step(state, video, labels, metadata)

        return recorded_step

    def counted_precise(*args, **kwargs):
        t0 = time.perf_counter()
        batches = compute(*args, **kwargs)
        precise.append((batches, time.perf_counter() - t0))
        return batches

    train_net.train, test_net.test = counted_train, counted_test
    trainer.make_supervised_train_step = recording_make
    trainer.compute_precise_bn_stats = counted_precise
    try:
        yield
    finally:
        (train_net.train, test_net.test, trainer.make_supervised_train_step,
         trainer.compute_precise_bn_stats) = saved


def trained_params(model):
    """The parameters on the host (float32), without the BatchNorm running
    buffers, which precise BN replaces in the loop alone and which no
    train-mode step reads."""
    return {n: p.detach().float().cpu() for n, p in model.named_parameters()}


def direct_data_steps(cfg, steps, steps_per_epoch):
    """``make_supervised_train_step`` over the batches the loop's steps
    received, in order, from the model and state the loop starts from
    (``build_model`` and ``build_supervised_state`` seeded with
    RNG_SEED; no checkpoint); each step timed alone (synchronized).
    Returns (losses, host parameters, seconds, clips, the initial host
    parameters)."""
    from focus_tpu_torch.engine import trainer
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.models.losses import get_loss_func

    model = build_model(cfg, DEV)
    state = trainer.build_supervised_state(cfg, model, steps_per_epoch)
    step = trainer.make_supervised_train_step(model, cfg, get_loss_func(cfg))
    model.train()
    init = trained_params(model)
    losses, seconds, clips = [], 0.0, 0
    for video, labels, metadata in steps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, stats = step(state, video, labels, metadata)
        torch.cuda.synchronize()
        seconds += time.perf_counter() - t0
        losses.append(stats["loss"].item())
        clips += trainer._batch_size(video)
    params = trained_params(model)
    del model, state, step
    torch.cuda.empty_cache()
    return losses, params, seconds, clips, init


def host_ms_per_clip(cfg, dataset_name, split, readers, clips_per_item=1):
    """``__getitem__`` of the dataset's split on DATA_HOST_ITEMS items, in
    this thread alone, with the substituted reads' seconds taken out: ms
    per clip, and the reads' ms per clip beside it."""
    from focus_tpu_torch.datasets.build import build_dataset

    dataset = build_dataset(dataset_name, cfg, split)
    read0 = readers.seconds
    t0 = time.perf_counter()
    for i in range(DATA_HOST_ITEMS):
        dataset[i]
    total = time.perf_counter() - t0
    read = readers.seconds - read0
    clips = DATA_HOST_ITEMS * clips_per_item
    return {"ms_per_clip": 1e3 * (total - read) / clips,
            "read_ms_per_clip": 1e3 * read / clips, "clips": clips}


def data_run(name, overrides, reductions, readers, epochs, steps_per_epoch,
             clips_per_item=1):
    """``tools.train_net`` then ``tools.test_net`` on ``DATA_YAMLS[name]``
    with ``overrides``, through the real dataset, transforms, loader and
    engine (only the reads substituted), in bf16; then the gates: finite
    losses, every step's batch of the expected clips, the loop against a
    direct step loop on the same batches (run twice, the second run
    showing the step's own spread; gated as DATA_LOOP_UPDATE_REL says),
    each validation's stats, the test reading the last checkpoint whole,
    every test clip scored once, the ensembles against a direct loop (DATA_LOOP_ATOL); and the
    numbers: each loop's clips/s, the step's alone, the wait share, the
    host's ms per clip of __getitem__ (read excluded), peak memory."""
    from focus_tpu_torch.config.defaults import assert_and_infer_cfg
    from focus_tpu_torch.tools import test_net, train_net
    from focus_tpu_torch.utils import checkpoint as cu
    from focus_tpu_torch.utils.parser import load_config, parse_args

    out_dir = os.path.join(DATA_ENGINE_DIR, name, "out")
    argv = ["--device", DEV, "--cfg",
            os.path.join(REPO, "configs", DATA_YAMLS[name]),
            "NUM_GPUS", "1", "TRAIN.AUTO_RESUME", "False",
            "SOLVER.MAX_EPOCH", str(epochs), "TRAIN.EVAL_PERIOD", "1",
            "OUTPUT_DIR", out_dir] + overrides
    cfg = assert_and_infer_cfg(load_config(parse_args(argv)))
    runs, steps, precise = {"train": [], "test": []}, [], []
    t0 = time.perf_counter()
    with recorded_tools(runs, steps, precise):
        train_net.main(argv)
        test_net.main(argv)
    tools_s = time.perf_counter() - t0
    (tr, train_launches, train_peak), = runs["train"]
    (te, test_launches, test_peak), = runs["test"]
    problems = []
    losses = [x for epoch in tr.losses for x in epoch]
    want_clips = cfg.TRAIN.BATCH_SIZE * clips_per_item
    batch_clips = [len(labels) for _, labels, _ in steps]
    if not (tr.steps == epochs * steps_per_epoch == len(steps)
            and all(math.isfinite(x) for x in losses)
            and batch_clips == [want_clips] * len(steps)):
        problems.append(f"train: {tr.steps} steps, losses {losses}, clips a "
                        f"step {batch_clips}")
    if any(train_launches.values()) or any(test_launches.values()):
        problems.append("a hand-written kernel launched: "
                        f"{train_launches} {test_launches}")
    pairs = None
    if clips_per_item > 1:  # each video's views adjacent, one label
        pairs = all(torch.equal(lab[0::2], lab[1::2])
                    for _, lab, _ in steps)
        if not pairs:
            problems.append("repeated views' labels do not pair")
    loop_params = trained_params(tr.state.model)
    state_tensors = len(tr.state.model.state_dict())
    del tr.state
    torch.cuda.empty_cache()
    direct, direct_params, step_s, step_clips, init = direct_data_steps(
        cfg, steps, steps_per_epoch)
    # the direct loop once more: the step's own run-to-run spread on the card
    again, again_params = direct_data_steps(cfg, steps, steps_per_epoch)[:2]
    multi = bool(cfg.DATA.MULTI_LABEL)
    first_step_labels = steps[0][1].cpu()
    del steps
    torch.cuda.empty_cache()

    def gaps(losses_a, params_a, losses_b, params_b):
        by_step = [abs(a - b) / abs(b) for a, b in zip(losses_a, losses_b)]
        return {"bit_equal": losses_a == losses_b and all(
                    torch.equal(params_a[k], params_b[k]) for k in params_a),
                "loss_rel_err_by_step": by_step,
                "max_loss_rel_err": max(by_step),
                "params_rel_l2": params_rel_l2(params_a, params_b)}

    vs_direct = gaps(losses, loop_params, direct, direct_params)
    repeat = gaps(again, again_params, direct, direct_params)
    moved = {k: direct_params[k] - init[k] for k in init}
    vs_direct["params_moved_rel_l2"] = params_rel_l2(direct_params, init)
    vs_direct["update_rel_l2"] = params_rel_l2(
        {k: loop_params[k] - init[k] for k in init}, moved)
    del init, moved
    if not (losses[0] == direct[0]
            and vs_direct["max_loss_rel_err"] <= TRAIN_LOOP_LOSS_REL
            and vs_direct["params_rel_l2"] <= TRAIN_LOOP_PARAM_REL
            and vs_direct["update_rel_l2"] <= DATA_LOOP_UPDATE_REL):
        problems.append(f"loop vs direct loop: {vs_direct}")
    want_keys = ["epoch", "map"] if multi else ["epoch", "top1_err",
                                                 "top5_err"]
    for stats in tr.val_stats:
        values = [v for k, v in stats.items() if k != "epoch"]
        if sorted(stats) != want_keys or not all(
                v is not None and math.isfinite(v) for v in values) or (
                multi and not 0.0 <= stats["map"] <= 1.0):
            problems.append(f"val stats {stats}")
    if len(tr.val_stats) != epochs or [b for b, _ in precise] != (
            [cfg.BN.NUM_BATCHES_PRECISE] * epochs
            if cfg.BN.USE_PRECISE_STATS else []):
        problems.append(f"{len(tr.val_stats)} validations, precise BN "
                        f"{precise}")
    meter = te.meter
    views = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    last = cu.get_last_checkpoint(cfg.OUTPUT_DIR)
    whole = bool(te.checkpoint and te.checkpoint["path"] == last
                 and not te.checkpoint["missing"]
                 and len(te.checkpoint["loaded"]) == state_tensors)
    once = bool((meter.clip_count == views).all()
                and meter.seen_clips.sum() == te.clips)
    direct_err = conv_direct_test(cfg, last, meter)
    if not (whole and once and direct_err <= DATA_LOOP_ATOL):
        problems.append(f"test: checkpoint whole {whole}, every clip once "
                        f"{once}, vs direct {direct_err:.3e}")
    if multi and not 0.0 <= te.stats["map"] <= 1.0:
        problems.append(f"test map {te.stats['map']}")
    host = {}
    for split in ("train", "val", "test"):
        host[split] = host_ms_per_clip(
            cfg, cfg.TEST.DATASET if split == "test" else cfg.TRAIN.DATASET,
            split, readers, clips_per_item if split == "train" else 1)
    return {
        "ok": not problems, "problems": problems,
        "yaml": "configs/" + DATA_YAMLS[name], "reductions": reductions,
        "train": {"steps": tr.steps, "clips": tr.clips,
                  "clips_per_step": want_clips, "losses": tr.losses,
                  "labels_pair_up": pairs,
                  "first_step_labels_shape": list(first_step_labels.shape),
                  "val_stats": tr.val_stats, "val_clips": tr.val_clips,
                  "precise_bn_batches": [b for b, _ in precise],
                  "precise_bn_seconds": [t for _, t in precise],
                  "checkpoint_seconds": tr.checkpoint_seconds,
                  "train_loop_clips_per_sec": tr.clips / tr.seconds,
                  "step_clips_per_sec": step_clips / step_s,
                  "wait_share": tr.wait_seconds / tr.seconds,
                  "wait_share_without_first_batches":
                      (tr.wait_seconds - tr.first_wait_seconds) / tr.seconds,
                  "val_clips_per_sec": tr.val_clips / tr.val_seconds,
                  "loop_seconds": tr.seconds, "step_seconds": step_s,
                  "peak_memory_gb": train_peak,
                  "launches": train_launches},
        "vs_direct_loop": vs_direct, "direct_loop_vs_its_repeat": repeat,
        "test": {"stats": {k: v if isinstance(v, str) else float(v)
                           for k, v in te.stats.items()},
                 "clips": int(te.clips), "batches": int(te.batches),
                 "views": views, "ensemble": meter.ensemble_method,
                 "checkpoint": os.path.relpath(last, REPO),
                 "loaded_whole": whole, "every_clip_counted_once": once,
                 "vs_direct_loop_max_abs": direct_err,
                 "atol": DATA_LOOP_ATOL,
                 "test_loop_clips_per_sec": te.clips / te.seconds,
                 "wait_share": te.wait_seconds / te.seconds,
                 "peak_memory_gb": test_peak},
        "host_ms_per_clip_read_excluded": host,
        "tools_seconds": tools_s}


def data_kinetics(root, readers):
    """(A) MViT-B 16x4's Kinetics recipe: 2 epochs of 4 steps at 4 videos
    x NUM_SAMPLE 2 = 8 clips a step (the loader flattens the views),
    RandAugment (PIL), pixel random erasing at RE_PROB 0.25, the relative
    scale / aspect crop, mixup / CutMix in the step; validation each epoch; then the test at
    batch 8 with the yaml's 10 temporal views x 1 crop."""
    reductions = {
        "SOLVER.MAX_EPOCH": "2 (200)", "TRAIN.EVAL_PERIOD": "1 (10)",
        "TRAIN.BATCH_SIZE": "4 (16 over NUM_GPUS 8 is 2): 8 clips a step",
        "TEST.BATCH_SIZE": "8 (64 over NUM_GPUS 8)",
        "NUM_GPUS": "1 (8)", "TRAIN.AUTO_RESUME": "False (True)",
        "data": "16 train, 8 val, 4 test videos (Kinetics-400: 240k / 20k "
                "/ 20k); the reads substituted (InScriptReaders)"}
    overrides = ["DATA.PATH_TO_DATA_DIR", root, "TRAIN.BATCH_SIZE", "4",
                 "TEST.BATCH_SIZE", "8"]
    return data_run("kinetics", overrides, reductions, readers, epochs=2,
                    steps_per_epoch=4, clips_per_item=2)


def data_charades(root, readers):
    """(B) SlowFast 16x8 R50's Charades recipe: 64 fast / 16 slow frames,
    157 classes, multi-hot labels under bce_logit, 2 epochs of 4 steps at
    batch 4 with precise BN over 2 batches and validation's mAP each
    epoch; then 10 views x 3 crops under max at batch 8, scored by mAP."""
    reductions = {
        "TRAIN.CHECKPOINT_FILE_PATH": '"" (SLOWFAST_8x8_R50.pkl, caffe2): '
                                      "not in the repository; random init",
        "SOLVER.MAX_EPOCH": "2 (57)", "TRAIN.EVAL_PERIOD": "1 (6)",
        "TRAIN.BATCH_SIZE": "4 (16 over NUM_GPUS 8 is 2)",
        "TEST.BATCH_SIZE": "8 (16)", "BN.NUM_BATCHES_PRECISE": "2 (200)",
        "NUM_GPUS": "1 (8)", "TRAIN.AUTO_RESUME": "False (True)",
        "data": f"16 train, 4 val / test videos of {DATA_CHARADES_FRAMES} "
                "frames (Charades: 7985 / 1863 videos); the reads "
                "substituted (InScriptReaders)"}
    overrides = ["DATA.PATH_TO_DATA_DIR", root,
                 "DATA.PATH_PREFIX", os.path.join(root, "frames"),
                 "TRAIN.CHECKPOINT_FILE_PATH", "", "TRAIN.BATCH_SIZE", "4",
                 "TEST.BATCH_SIZE", "8", "BN.NUM_BATCHES_PRECISE", "2"]
    return data_run("charades", overrides, reductions, readers, epochs=2,
                    steps_per_epoch=4)


def data_imagenet(root, readers):
    """(C) MViT-B's ImageNet recipe (2-D patches): 4 steps at batch 32
    with mixup / CutMix, validation, then a test pass over the val
    images."""
    reductions = {
        "SOLVER.MAX_EPOCH": "1 (300)", "TRAIN.EVAL_PERIOD": "1 (10)",
        "TRAIN.BATCH_SIZE": "32 (256 over NUM_GPUS 8)",
        "TEST.BATCH_SIZE": "32 (256)", "TEST.ENABLE": "False, but "
        "tools.test_net tests all the same",
        "TEST.NUM_ENSEMBLE_VIEWS / NUM_SPATIAL_CROPS": "1 / 1 (10 / 3): "
        "an image is one centre crop",
        "NUM_GPUS": "1 (8)", "TRAIN.AUTO_RESUME": "False (True)",
        "data": "128 train, 32 val images (ImageNet-1k: 1.28M / 50k); the "
                "reads substituted (InScriptReaders)"}
    overrides = ["DATA.PATH_TO_DATA_DIR", root, "TRAIN.BATCH_SIZE", "32",
                 "TEST.BATCH_SIZE", "32", "TEST.NUM_ENSEMBLE_VIEWS", "1",
                 "TEST.NUM_SPATIAL_CROPS", "1"]
    return data_run("imagenet", overrides, reductions, readers, epochs=1,
                    steps_per_epoch=4)


def phase_datasets(smi):
    """Phase 18: the remaining datasets behind the card. Kinetics (MViT-B
    16x4, repeated augmentation and random erasing), Charades (SlowFast
    16x8, multi-label, mAP) and ImageNet (MViT-B, 2-D) through
    ``tools.train_net`` then ``tools.test_net`` as shipped, at full width
    in bf16, with only the file reads substituted (``InScriptReaders``);
    the first numbers of the port with real host transforms behind the
    card. No hand-written kernel runs on these paths, so none is counted
    (each run's launch counts are checked to be 0)."""
    from focus_tpu_torch.utils import logging as port_logging

    shutil.rmtree(DATA_ENGINE_DIR, ignore_errors=True)
    result = {"phase": "datasets", "gpu": smi}
    t0 = time.perf_counter()
    try:
        roots = write_data_lists(DATA_ENGINE_DIR)
        readers = InScriptReaders()
        with open(DATA_ENGINE_LOG, "w") as log, contextlib.redirect_stdout(
                log), readers.installed():
            result["kinetics_mvit"] = data_kinetics(roots["kinetics"],
                                                    readers)
            result["charades_slowfast"] = data_charades(roots["charades"],
                                                        readers)
            result["imagenet_mvit"] = data_imagenet(roots["imagenet"],
                                                    readers)
    finally:
        port_logging.close_logging()
        shutil.rmtree(DATA_ENGINE_DIR, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t0
    parts = [v for v in result.values() if isinstance(v, dict) and "ok" in v]
    result["ok"] = len(parts) == 3 and all(v["ok"] for v in parts)
    emit(result)
    if not result["ok"]:
        failed = sorted(k for k, v in result.items()
                        if isinstance(v, dict) and not v.get("ok", True))
        raise AssertionError(f"datasets phase failed: {failed}")


# ---- phase 19: the Switch-MoE Motionformer ----------------------------------

MOE_ENGINE_DIR = os.path.join(REPO, "build", "moe_engine")
MOE_ENGINE_LOG = os.path.join(REPO, "build", "moe_engine.log")
MOE_YAML_REL = "configs/TPU/SSv2_MF_224_16x4_pp_moe.yaml"
MOE_BATCH = 8  # the flagship's; the yaml's 48 is over 8 TPU chips
MOE_EVAL_ITERS = 10
MOE_TRAIN_WARMUP, MOE_TRAIN_ITERS = 2, 5
# the bf16 model on the kernels against the same model on the plain path:
# a token routed to another expert by a last-bit difference changes its MLP
# output wholesale, so the probabilities are held as the serving variants'
MOE_PROB_ATOL = VARIANT_PROB_ATOL
MOE_CMP_BATCH = 2
MOE_LOSS_REL = 1e-4
MOE_GRAD_REL_L2 = 1e-3
MOE_ROUTE_GAP = 1e-3  # a routing flip is a tie only within this gap
MOE_LOOP_STEPS = 4  # steps an epoch, 2 epochs
MOE_TRAIN_CLIPS, MOE_VAL_CLIPS = MOE_LOOP_STEPS * MOE_BATCH, 12


@contextlib.contextmanager
def recorded_routes(records):
    """Every ``MoEMlp.route`` call's (probabilities, expert, gate,
    position, cap), detached, appended to ``records`` in call order (the
    blocks' order in a forward); the method restored after."""
    from focus_tpu_torch.models import moe

    route = moe.MoEMlp.route

    def recording(self, x):
        out = route(self, x)
        records.append(tuple(o.detach() if torch.is_tensor(o) else o
                             for o in out))
        return out

    moe.MoEMlp.route = recording
    try:
        yield
    finally:
        moe.MoEMlp.route = route


def route_stats(records):
    """Each layer's share of tokens dropped at capacity and each expert's
    load (its share of the tokens routed to it, drops included)."""
    dropped, load = [], []
    for _, idx, _, pos, cap in records:
        e = records[0][0].shape[-1]
        dropped.append((pos >= cap).float().mean().item())
        load.append((torch.bincount(idx.reshape(-1), minlength=e).float()
                     / idx.numel()).tolist())
    return {"dropped_share_by_layer": dropped, "expert_load_by_layer": load,
            "cap": records[0][4] if records else None}


def layer_kernels(fn, iters=3, top=12):
    """The ``top`` device kernels of ``fn`` by time under torch.profiler:
    ms and launches a call, the most time first."""
    from torch.profiler import ProfilerActivity, profile

    from focus_tpu_torch.profile_slice import device_rows

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {name[:90]: {"device_ms_per_call": us / 1e3 / iters,
                        "launches_per_call": count / iters}
            for name, count, us in device_rows(prof)[:top]}


def moe_layer_split(model, backward=False):
    """One MoE layer (block 0's) on a LayerNorm-scaled input of the main
    path's shape [8, 1569, 768] bf16: ms by CUDA events of the whole layer,
    the routing (``route``) and the expert products (``experts`` on
    [4, 8 * cap, 768]) alone, the dispatch and combine as the rest; and the
    layer's device kernels by name. ``backward``: each part forward and
    backward."""
    mlp = model.blocks[0].mlp
    gen = torch.Generator(device=DEV)
    gen.manual_seed(5)
    x = torch.randn(MOE_BATCH, 1569, model.embed_dim, generator=gen,
                    device=DEV).to(torch.bfloat16)
    cap = mlp.route(x)[4]
    xe = torch.randn(mlp.num_experts, MOE_BATCH * cap, model.embed_dim,
                     generator=gen, device=DEV).to(torch.bfloat16)
    if backward:
        x.requires_grad_()
        xe.requires_grad_()

    def run(f):
        def call():
            out = f()
            if backward:
                out = out[0] if isinstance(out, tuple) else out
                out.float().sum().backward()
        return call

    parts = {"layer": run(lambda: mlp(x)),
             "routing": run(lambda: mlp.route(x)[0]),
             "expert_products": run(lambda: mlp.experts(xe))}
    ms = {k: time_ms(f, warmup=2, iters=10) for k, f in parts.items()}
    ms["dispatch_and_combine"] = (ms["layer"] - ms["routing"]
                                  - ms["expert_products"])
    return {"input": [MOE_BATCH, 1569, model.embed_dim], "cap": cap,
            "backward": backward, "ms": ms,
            "kernels": layer_kernels(parts["layer"])}


def moe_eval():
    """(a) ``moe_entry(batch=8)``: the eval forward in bf16 through kernels
    1 and 2, ms by CUDA events (median), clips/s, peak memory, the tokens
    dropped at capacity and each expert's load by layer, the busy share and
    the device time by kind under torch.profiler, one MoE layer's split;
    12 kernel-1 and 1 kernel-2 launches a forward (over SLICE_ITERS, the
    counts reset just before); the probabilities against the same model on
    the plain path."""
    from focus_tpu_torch.entry import moe_entry
    from focus_tpu_torch.ops import patch_embed as pe
    from focus_tpu_torch.ops import trajectory_block as tb

    fn, (video,) = moe_entry(device=DEV, batch=MOE_BATCH)
    model = fn.model
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: fn(video), warmup=2, iters=MOE_EVAL_ITERS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.synchronize()
    reset_counts()
    for _ in range(SLICE_ITERS):
        fn(video)
    torch.cuda.synchronize()
    launches = {"trajectory_block": tb.LAUNCHES, "patch_embed": pe.LAUNCHES,
                "trajectory_block_bwd": tb.BWD_LAUNCHES}
    records = []
    with recorded_routes(records):
        probs = fn(video)
    model.use_kernels = False
    plain_records = []
    with recorded_routes(plain_records):
        plain = fn(video)
    model.use_kernels = True
    agree = [float((a[1] == b[1]).float().mean())
             for a, b in zip(records, plain_records)]
    result = {
        "model": f"Switch-MoE Motionformer ({MOE_YAML_REL} with "
                 "TPU.MESH.PIPE 1 TPU.MESH.EXPERT 1 NUM_GPUS 1: D=768, 12 "
                 "blocks, 4 experts, capacity factor 1.25), bf16, the JAX "
                 "package's initialisers (seed 0)",
        "clip": list(video.shape), "batch": MOE_BATCH,
        "ms": ms, "clips_per_sec": MOE_BATCH / (ms / 1e3),
        "peak_memory_gb": peak, "launches": launches,
        "routes": route_stats(records),
        "profile": profiled_share(lambda: fn(video)),
        "layer_split": moe_layer_split(model),
        "probs_shape": list(probs.shape),
        "finite": bool(torch.isfinite(probs).all()),
        "sums_to_one": (probs.float().sum(-1) - 1).abs().max().item(),
        "vs_plain_path": {"max_abs_err": (probs - plain).abs().max().item(),
                          "atol": MOE_PROB_ATOL,
                          "routing_agreement_by_layer": agree}}
    result["ok"] = (result["finite"] and result["sums_to_one"] < 1e-3
                    and list(probs.shape) == [MOE_BATCH, 174]
                    and len(records) == 12
                    and launches == {"trajectory_block": 12 * SLICE_ITERS,
                                     "patch_embed": SLICE_ITERS,
                                     "trajectory_block_bwd": 0}
                    and result["vs_plain_path"]["max_abs_err"]
                    <= MOE_PROB_ATOL)
    del fn, model, video
    torch.cuda.empty_cache()
    return result


def moe_train():
    """(b) ``moe_train_entry(batch=8)``: AdamW steps in bf16 (float32
    masters) with the load-balance loss and drop path 0.2: ms a step by
    CUDA events (median), train clips/s, peak memory, finite loss, aux and
    gradients, the drops and loads of one step, the busy share and device
    time by kind, one MoE layer's split forward and backward; 12 kernel-1,
    12 kernel-7 and 1 kernel-2 launches a step (over TRAIN_ITERS)."""
    from focus_tpu_torch.entry import moe_train_entry
    from focus_tpu_torch.ops import patch_embed as pe
    from focus_tpu_torch.ops import trajectory_block as tb

    fn, (video, labels) = moe_train_entry(device=DEV, batch=MOE_BATCH)
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: fn(video, labels), warmup=MOE_TRAIN_WARMUP,
                 iters=MOE_TRAIN_ITERS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.synchronize()
    reset_counts()
    for _ in range(TRAIN_ITERS):
        fn(video, labels)
    torch.cuda.synchronize()
    launches = {"trajectory_block": tb.LAUNCHES, "patch_embed": pe.LAUNCHES,
                "trajectory_block_bwd": tb.BWD_LAUNCHES}
    records = []
    with recorded_routes(records):
        stats = {k: v.item() for k, v in fn(video, labels).items()}
    result = {"batch": MOE_BATCH, "clip": list(video.shape),
              "solver": "the yaml's: AdamW, weight decay 5e-2 "
                        "(ZERO_WD_1D_PARAM off), steps_with_relative_lrs; "
                        "label-smoothing cross-entropy + 0.01 x moe_aux; "
                        "drop path to 0.2",
              "ms_per_step": ms,
              "train_clips_per_sec": MOE_BATCH / (ms / 1e3),
              "peak_memory_gb": peak, "stats": stats, "launches": launches,
              "routes": route_stats(records),
              "finite": math.isfinite(stats["loss"])
              and math.isfinite(stats["moe_aux"]) and finite_grads(fn.model),
              "profile": profiled_share(lambda: fn(video, labels)),
              "layer_split": moe_layer_split(fn.model, backward=True)}
    result["ok"] = (result["finite"] and len(records) == 12
                    and launches == {"trajectory_block": 12 * TRAIN_ITERS,
                                     "patch_embed": TRAIN_ITERS,
                                     "trajectory_block_bwd":
                                         12 * TRAIN_ITERS})
    del fn, video, labels
    torch.cuda.empty_cache()
    return result


def moe_card_vs_cpu():
    """(c) One train step at batch 2 in float32 (plain path on both, the
    kernels being bf16; no drop path: the devices draw apart) from the same
    weights and batch on the card and on the CPU: every layer's routing
    compared; where none flips, the loss and moe_aux within MOE_LOSS_REL
    and each gradient within MOE_GRAD_REL_L2 relative L2. A flipped token
    is printed with its probability gap on the CPU (top-1 minus top-2), the
    gap must be a tie's (MOE_ROUTE_GAP), and the first flipping layer's
    routing inputs are held on the agreeing tokens instead."""
    from focus_tpu_torch.engine.trainer import (
        build_supervised_state,
        make_supervised_train_step,
    )
    from focus_tpu_torch.entry import example_inputs, moe_cfg
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.models.losses import get_loss_func

    cfg = moe_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.MF.DROP_PATH = 0.0
    weights = build_model(cfg, "cpu", seed=0).state_dict()
    runs = {}
    for dev in ("cpu", DEV):
        model = build_model(cfg, dev, seed=0)
        model.load_state_dict(weights)
        model.use_kernels = False
        state = build_supervised_state(cfg, model, 100)
        step = make_supervised_train_step(model, cfg, get_loss_func(cfg))
        video, labels, _ = example_inputs(cfg, MOE_CMP_BATCH, 1, dev,
                                          labels=True)
        records = []
        t0 = time.perf_counter()
        with recorded_routes(records):
            _, stats = step(state, video, labels, {})
        stats = {k: v.item() for k, v in stats.items()}
        runs[dev] = (stats, {k: p.grad.detach().double().cpu()
                             for k, p in model.named_parameters()},
                     [tuple(o.cpu() if torch.is_tensor(o) else o for o in r)
                      for r in records], time.perf_counter() - t0)
        del model, state, step, video, labels
    torch.cuda.empty_cache()
    (s_c, g_c, r_c, sec_c), (s_g, g_g, r_g, sec_g) = runs["cpu"], runs[DEV]
    flips = []
    for layer, (rc, rg) in enumerate(zip(r_c, r_g)):
        for b, t in (rc[1] != rg[1]).nonzero().tolist():
            top2 = rc[0][b, t].topk(2).values
            flips.append({"layer": layer, "sample": b, "token": t,
                          "cpu_expert": int(rc[1][b, t]),
                          "card_expert": int(rg[1][b, t]),
                          "cpu_prob_gap": float(top2[0] - top2[1])})
    for f in flips:
        print(f"moe routing flip: {f}", flush=True)

    def rel(a, b):
        return (a - b).norm().item() / max(b.norm().item(), 1e-30)

    compared = {k: rel(g_g[k], g_c[k]) for k in g_c if g_c[k].norm() > 0}
    worst = max(compared, key=compared.get)
    result = {"batch": MOE_CMP_BATCH,
              "dtype": "float32 (TF32 off), the plain path on both",
              "routing_flips": flips,
              "routing_compared_layers": len(r_c),
              "loss": {"card": s_g["loss"], "cpu": s_c["loss"],
                       "rel_err": abs(s_g["loss"] - s_c["loss"])
                       / abs(s_c["loss"])},
              "moe_aux": {"card": s_g["moe_aux"], "cpu": s_c["moe_aux"],
                          "rel_err": abs(s_g["moe_aux"] - s_c["moe_aux"])
                          / abs(s_c["moe_aux"])},
              "grads_compared": len(compared),
              "worst_grad_rel_l2": {"name": worst, "value": compared[worst]},
              "step_seconds": {"card": sec_g, "cpu": sec_c},
              "tolerances": {"loss_rel": MOE_LOSS_REL,
                             "grad_rel_l2": MOE_GRAD_REL_L2,
                             "route_gap": MOE_ROUTE_GAP}}
    if not flips:
        result["ok"] = (len(r_c) == len(r_g) == 12
                        and result["loss"]["rel_err"] <= MOE_LOSS_REL
                        and result["moe_aux"]["rel_err"] <= MOE_LOSS_REL
                        and compared[worst] <= MOE_GRAD_REL_L2)
    else:
        first = flips[0]["layer"]
        agree = r_c[first][1] == r_g[first][1]
        gap = (r_c[first][0] - r_g[first][0]).abs()[agree].max().item()
        result["first_flip_layer_probs_on_agreeing_tokens"] = gap
        result["ok"] = (all(f["cpu_prob_gap"] <= MOE_ROUTE_GAP for f in flips)
                        and gap <= MOE_ROUTE_GAP)
    return result


class MoETestClips(SSv2TestClips):
    VIDEOS = 4  # x 1 view x 3 crops: 12 clips, a padded last batch at 8


def moe_loops():
    """(d) ``tools.train_net`` then ``tools.test_net`` on the MoE yaml with
    the one-card overrides over in-script SSv2 splits (``TrainClips``,
    ``MoETestClips``): 2 epochs of 4 steps at batch 8 with validation after
    each and a checkpoint at the last, then the test path from it; the loop
    against a direct step loop on the same batches (phase 18's gates), the
    validation's stats, every test clip scored once, the ensembles against
    a direct loop; 12 kernel-1, 12 kernel-7 and 1 kernel-2 launches a
    step."""
    from focus_tpu_torch.config.defaults import assert_and_infer_cfg
    from focus_tpu_torch.tools import test_net, train_net
    from focus_tpu_torch.utils import checkpoint as cu
    from focus_tpu_torch.utils.parser import load_config, parse_args

    reductions = {
        "SOLVER.MAX_EPOCH": "2 (35)", "TRAIN.EVAL_PERIOD": "1 (5)",
        "TRAIN.CHECKPOINT_PERIOD": "2 (1): one save",
        "TRAIN.BATCH_SIZE / TEST.BATCH_SIZE": f"{MOE_BATCH} ({MOE_BATCH}: "
                                              "the yaml's 48 and 64 are over "
                                              "8 TPU chips)",
        "TPU.MESH.PIPE / EXPERT, NUM_GPUS": "1 / 1, 1 (2 / 2, 8): one card",
        "TRAIN.AUTO_RESUME": "False (True): a fresh output directory",
        "data": f"in-script: {MOE_TRAIN_CLIPS} train, {MOE_VAL_CLIPS} val "
                f"clips, {MoETestClips.VIDEOS} test videos x 3 crops "
                "(SSv2: 169k / 25k videos)"}
    argv = ["--device", DEV, "--cfg", os.path.join(REPO, MOE_YAML_REL),
            "TRAIN.METHOD", "sup", "TEST.EVAL_TASK", "ar",
            "TPU.MESH.PIPE", "1", "TPU.MESH.EXPERT", "1", "NUM_GPUS", "1",
            "TRAIN.BATCH_SIZE", str(MOE_BATCH),
            "TEST.BATCH_SIZE", str(MOE_BATCH), "SOLVER.MAX_EPOCH", "2",
            "TRAIN.EVAL_PERIOD", "1", "TRAIN.CHECKPOINT_PERIOD", "2",
            "TRAIN.AUTO_RESUME", "False", "DATA_LOADER.NUM_WORKERS", "4",
            "LOG_PERIOD", "1", "OUTPUT_DIR", MOE_ENGINE_DIR]
    cfg = assert_and_infer_cfg(load_config(parse_args(argv)))

    def splits(cfg_, mode):
        if mode == "test":
            return MoETestClips(cfg_, mode)
        return TrainClips(cfg_, mode, MOE_TRAIN_CLIPS if mode == "train"
                          else MOE_VAL_CLIPS, False)

    import focus_tpu_torch.datasets.ssv2  # noqa: F401 (registered first)

    runs, steps, precise = {"train": [], "test": []}, [], []
    t0 = time.perf_counter()
    with registered_splits({"Ssv2": splits}), epoch_seeded_splits():
        with recorded_tools(runs, steps, precise):
            train_net.main(argv)
            test_net.main(argv)
        tools_s = time.perf_counter() - t0
        (tr, train_launches, train_peak), = runs["train"]
        (te, test_launches, test_peak), = runs["test"]
        losses = [x for epoch in tr.losses for x in epoch]
        loop_params = trained_params(tr.state.model)
        del tr.state
        torch.cuda.empty_cache()
        direct, direct_params, step_s, step_clips, init = direct_data_steps(
            cfg, steps, MOE_LOOP_STEPS)
        n_steps = len(steps)
        del steps
        last = cu.get_last_checkpoint(cfg.OUTPUT_DIR)
        direct_err = conv_direct_test(cfg, last, te.meter)
    vs_direct = {
        "loss_rel_err_by_step": [abs(a - b) / abs(b)
                                 for a, b in zip(losses, direct)],
        "params_rel_l2": params_rel_l2(loop_params, direct_params),
        "update_rel_l2": params_rel_l2(
            {k: loop_params[k] - init[k] for k in init},
            {k: direct_params[k] - init[k] for k in init}),
        "first_loss_bit_equal": losses[0] == direct[0]}
    views = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    once = bool((te.meter.clip_count == views).all()
                and te.meter.seen_clips.sum() == te.clips)
    per_step = 12 * 2 * MOE_LOOP_STEPS  # kernel-1 launches of the steps
    val_batches = -(-MOE_VAL_CLIPS // MOE_BATCH)
    want_train = {"trajectory_block": per_step + 12 * 2 * val_batches,
                  "trajectory_block_bwd": per_step,
                  "patch_embed": 2 * MOE_LOOP_STEPS + 2 * val_batches}
    got_train = {k: train_launches[k] for k in want_train}
    result = {
        "reductions": reductions,
        "train": {"steps": tr.steps, "clips": tr.clips, "losses": tr.losses,
                  "val_stats": tr.val_stats, "val_clips": tr.val_clips,
                  "checkpoint_seconds": tr.checkpoint_seconds,
                  "train_loop_clips_per_sec": tr.clips / tr.seconds,
                  "step_clips_per_sec": step_clips / step_s,
                  "wait_share": tr.wait_seconds / tr.seconds,
                  "val_clips_per_sec": tr.val_clips / tr.val_seconds,
                  "peak_memory_gb": train_peak, "launches": got_train,
                  "launches_expected": want_train},
        "vs_direct_loop": vs_direct,
        "test": {"stats": {k: v if isinstance(v, str) else float(v)
                           for k, v in te.stats.items()},
                 "clips": int(te.clips), "batches": int(te.batches),
                 "every_clip_counted_once": once,
                 "vs_direct_loop_max_abs": direct_err,
                 "atol": DATA_LOOP_ATOL,
                 "test_loop_clips_per_sec": te.clips / te.seconds,
                 "peak_memory_gb": test_peak,
                 "launches": {k: test_launches[k]
                              for k in ("trajectory_block", "patch_embed")}},
        "tools_seconds": tools_s}
    result["ok"] = (
        tr.steps == n_steps == 2 * MOE_LOOP_STEPS
        and all(math.isfinite(x) for x in losses)
        and vs_direct["first_loss_bit_equal"]
        and max(vs_direct["loss_rel_err_by_step"]) <= TRAIN_LOOP_LOSS_REL
        and vs_direct["params_rel_l2"] <= TRAIN_LOOP_PARAM_REL
        and vs_direct["update_rel_l2"] <= DATA_LOOP_UPDATE_REL
        and len(tr.val_stats) == 2 and got_train == want_train
        and once and direct_err <= DATA_LOOP_ATOL
        and test_launches["trajectory_block"] == 12 * te.batches)
    return result


def moe_mesh_refusal():
    """(e) The yaml as shipped (TPU.MESH.PIPE 2, EXPERT 2) through
    ``tools.run_net`` on the one card: the JAX package's refusal of a
    world that the axes do not divide (ValueError naming them; phase 23
    runs the yaml's mesh as 8 ranks) before any model, loader or
    launch."""
    from focus_tpu_torch.tools import run_net

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    reset_counts()
    try:
        run_net.main(["--device", DEV, "--cfg",
                      os.path.join(REPO, MOE_YAML_REL), "TRAIN.METHOD", "sup",
                      "TEST.EVAL_TASK", "ar", "OUTPUT_DIR", MOE_ENGINE_DIR])
        refusal = "no error"
    except ValueError as e:
        refusal = str(e)
    launches = train_counts()
    return {"refusal": refusal, "launches": launches,
            "allocated_bytes_added": torch.cuda.memory_allocated() - before,
            "ok": "TPU.MESH.PIPE 2" in refusal and "TPU.MESH.EXPERT 2" in
            refusal and not any(launches.values())
            and torch.cuda.memory_allocated() == before}


def phase_moe(smi):
    """Phase 19: the Switch-MoE Motionformer on one card, every expert on
    it. (a) its eval forward at batch 8, (b) its train step at batch 8,
    (c) at batch 2 in float32 the card against the CPU, (d) the train and
    test loops through the tools, (e) the yaml's own mesh refused. The
    path runs kernels 1, 2 and 7; the MoE layers are plain PyTorch (the
    JAX package computes them outside any Pallas kernel). Returns the
    launch counts of (a) and (b)."""
    from focus_tpu_torch.utils import logging as port_logging

    shutil.rmtree(MOE_ENGINE_DIR, ignore_errors=True)
    result = {"phase": "moe", "gpu": smi}
    t0 = time.perf_counter()
    try:
        result["moe_eval"] = moe_eval()
        result["moe_train"] = moe_train()
        result["moe_card_vs_cpu"] = moe_card_vs_cpu()
        with open(MOE_ENGINE_LOG, "w") as log, contextlib.redirect_stdout(
                log):
            result["moe_loops"] = moe_loops()
        result["moe_mesh_refusal"] = moe_mesh_refusal()
    finally:
        port_logging.close_logging()
        shutil.rmtree(MOE_ENGINE_DIR, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t0
    parts = [v for v in result.values() if isinstance(v, dict) and "ok" in v]
    result["ok"] = len(parts) == 5 and all(v["ok"] for v in parts)
    emit(result)
    if not result["ok"]:
        failed = sorted(k for k, v in result.items()
                        if isinstance(v, dict) and not v.get("ok", True))
        raise AssertionError(f"MoE phase failed: {failed}")
    return {"eval": result["moe_eval"]["launches"],
            "train": result["moe_train"]["launches"]}


# ---- phase 20: AVA detection --------------------------------------------------

AVA_ENGINE_DIR = os.path.join(REPO, "build", "ava_engine")
AVA_ENGINE_LOG = os.path.join(REPO, "build", "ava_engine.log")
AVA_YAMLS = {"slowfast": "AVA/SLOWFAST_32x2_R50_SHORT.yaml",
             "mvit": "AVA/MVIT_16X4.yaml", "slow_c2": "AVA/c2/SLOW_8x8_R50.yaml"}
AVA_BATCH = 8  # the yamls' TRAIN.BATCH_SIZE 64 / TEST.BATCH_SIZE 64 over 8
AVA_CLASSES = 80
AVA_TRAIN = (8, (902, 903, 904, 905))  # videos x seconds: 4 steps at 8
AVA_STEPS = AVA_TRAIN[0] * len(AVA_TRAIN[1]) // AVA_BATCH  # an epoch
AVA_VAL = (3, (904, 908, 912))  # 9 keyframes: 2 batches, 7 pad rows
AVA_VIDEO_FRAMES = 420  # 14 s at 30 fps: every clip of the seconds above
AVA_FRAME = DATA_FRAME  # short side 256
AVA_BANK_FRAMES = 96
AVA_PROB_REL = CONV_PROB_REL
AVA_MVIT_ITERS = 3


class AvaFrames:
    """The one substitution of phase 20: ``datasets/utils.retry_load_images``
    returns in-script uint8 frames of AVA_FRAME, a function of the file's
    name alone (the checkout holds no AVA frames), every read's seconds
    added to ``seconds``; the lists, annotations, dataset, transforms,
    loader and engine run as shipped."""

    def __init__(self, seed=0):
        import threading

        self.bank = np.random.default_rng(seed).integers(
            0, 256, (AVA_BANK_FRAMES, *AVA_FRAME, 3), dtype=np.uint8)
        self.lock = threading.Lock()
        self.seconds = 0.0

    def load_images(self, paths, retry=10):
        t0 = time.perf_counter()
        out = [self.bank[(37 * _file_number(os.path.dirname(p))
                          + _file_number(p)) % AVA_BANK_FRAMES]
               for p in paths]
        with self.lock:
            self.seconds += time.perf_counter() - t0
        return out

    @contextlib.contextmanager
    def installed(self):
        from focus_tpu_torch.datasets import utils as data_utils

        saved = data_utils.retry_load_images
        data_utils.retry_load_images = self.load_images
        try:
            yield self
        finally:
            data_utils.retry_load_images = saved


def write_ava_tree(root):
    """The files the AVA yamls read, under ``root``, named as the yamls and
    the config's defaults name them: ``frame_lists/{train,val}.csv``
    (AVA_VIDEO_FRAMES frames a video), the train ground truth
    (``ava_train_v2.2.csv``: 1-4 people a keyframe, 1-3 of the 80 actions
    each, a person id), the person detections of train (the ground truth's
    boxes jittered, and extra ones, some under the 0.8 score threshold) and
    val, the val ground truth, one excluded timestamp and a labelmap of 60
    of the 80 actions, as the official one has. Returns the overrides that
    point the yaml at them."""
    rs = np.random.RandomState(17)
    lists, ann = os.path.join(root, "frame_lists"), os.path.join(root,
                                                                  "annotations")
    det_dir = os.path.join(ann, "person_box_67091280_iou90")
    os.makedirs(lists)
    os.makedirs(det_dir)

    def box():
        x1, y1 = rs.rand(2) * 0.6
        w, h = rs.rand(2) * 0.3 + 0.08
        return [x1, y1, min(x1 + w, 1.0), min(y1 + h, 1.0)]

    def fmt(b):
        return [f"{v:.3f}" for v in b]

    tables = {}
    for split, (videos, secs) in (("train", AVA_TRAIN), ("val", AVA_VAL)):
        offset = 0 if split == "train" else 100
        names = [f"vid{offset + v}" for v in range(videos)]
        with open(os.path.join(lists, f"{split}.csv"), "w") as f:
            f.write("original_vido_id video_id frame_id path labels\n")
            for vi, name in enumerate(names):
                f.write("".join(f'{name} {vi} {t} {name}/{name}_{t + 1:06d}'
                                f'.jpg ""\n' for t in range(AVA_VIDEO_FRAMES)))
        gt, det = [], []
        for name in names:
            for sec in secs:
                for person in range(rs.randint(1, 5)):
                    b = box()
                    for label in rs.choice(np.arange(1, AVA_CLASSES + 1),
                                           rs.randint(1, 4), replace=False):
                        gt.append([name, sec, *fmt(b), int(label), person])
                    jit = np.clip(np.asarray(b) + rs.randn(4) * 0.01, 0, 1)
                    det.append([name, sec, *fmt(jit), "",
                                f"{0.85 + 0.15 * rs.rand():.6f}"])
                for _ in range(rs.randint(0, 3)):
                    det.append([name, sec, *fmt(box()), "",
                                f"{rs.rand():.6f}"])
        tables[split] = (gt, det)
    files = {"ava_train_v2.2.csv": tables["train"][0],
             "person_box_67091280_iou90/ava_detection_train_boxes_and_labels_"
             "include_negative_v2.2.csv": tables["train"][1],
             "person_box_67091280_iou90/ava_detection_val_boxes_and_labels"
             ".csv": tables["val"][1],
             "ava_val_v2.2.csv": tables["val"][0],
             "ava_val_excluded_timestamps_v2.2.csv": [["vid100", 912]]}
    for rel, rows in files.items():
        with open(os.path.join(ann, rel), "w") as f:
            f.write("".join(",".join(map(str, r)) + "\n" for r in rows))
    with open(os.path.join(
            ann, "ava_action_list_v2.2_for_activitynet_2019.pbtxt"), "w") as f:
        f.write("".join(f'item {{\n  name: "action {c}"\n  id: {c}\n}}\n'
                        for c in range(1, AVA_CLASSES + 1) if c % 4))
    return ["AVA.FRAME_DIR", os.path.join(root, "frames"),
            "AVA.FRAME_LIST_DIR", lists, "AVA.ANNOTATION_DIR", ann]


def ava_slowfast_loops(overrides, readers):
    """(a) ``tools.train_net`` then ``tools.test_net`` on
    configs/AVA/SLOWFAST_32x2_R50_SHORT.yaml at full width in bf16 (80
    classes, batch 8) over the in-script tree: 2 epochs of 4 steps with
    validation through AVAMeter after each (frame mAP, the official
    protocol's mini ground truth), a checkpoint at the last, then the test
    (the full ground truth). Gates: finite losses, no hand-written kernel
    launched, the loop against a direct step loop on the same batches
    (phase 18's gates), both validations' and the test's mAP in [0, 1],
    every test keyframe scored once with the loader's pad rows dropped.
    Numbers: the loop's and the step's clips/s, the wait share, the host's
    ms per clip of ``Ava.__getitem__`` without its read, peak memory."""
    from focus_tpu_torch.config.defaults import assert_and_infer_cfg
    from focus_tpu_torch.datasets.build import build_dataset
    from focus_tpu_torch.tools import test_net, train_net
    from focus_tpu_torch.utils.parser import load_config, parse_args

    reductions = {
        "SOLVER.MAX_EPOCH": "2 (20), inside the 5 warm-up epochs",
        "TRAIN.EVAL_PERIOD": "1 (5)",
        "TRAIN.CHECKPOINT_PERIOD": "2 (1): one save",
        "TRAIN.BATCH_SIZE / TEST.BATCH_SIZE": f"{AVA_BATCH} (64 over "
                                              "NUM_GPUS 8; 8)",
        "NUM_GPUS": "1 (8)", "TRAIN.AUTO_RESUME": "False (True)",
        "data": f"in-script: {AVA_TRAIN[0]} train videos x "
                f"{len(AVA_TRAIN[1])} keyframes, {AVA_VAL[0]} val x "
                f"{len(AVA_VAL[1])}, frames {AVA_FRAME[0]} x {AVA_FRAME[1]} "
                "(AVA v2.2: 235 / 64 videos, 211k / 57k keyframes); the reads "
                "substituted (AvaFrames)"}
    out_dir = os.path.join(AVA_ENGINE_DIR, "out")
    argv = ["--device", DEV, "--cfg",
            os.path.join(REPO, "configs", AVA_YAMLS["slowfast"]),
            "TRAIN.METHOD", "sup", "TEST.EVAL_TASK", "ar", "NUM_GPUS", "1",
            "TRAIN.BATCH_SIZE", str(AVA_BATCH),
            "TEST.BATCH_SIZE", str(AVA_BATCH), "SOLVER.MAX_EPOCH", "2",
            "TRAIN.EVAL_PERIOD", "1", "TRAIN.CHECKPOINT_PERIOD", "2",
            "TRAIN.AUTO_RESUME", "False", "LOG_PERIOD", "1",
            "OUTPUT_DIR", out_dir] + overrides
    cfg = assert_and_infer_cfg(load_config(parse_args(argv)))
    runs, steps, precise = {"train": [], "test": []}, [], []
    t0 = time.perf_counter()
    with recorded_tools(runs, steps, precise):
        train_net.main(argv)
        test_net.main(argv)
    tools_s = time.perf_counter() - t0
    (tr, train_launches, train_peak), = runs["train"]
    (te, test_launches, test_peak), = runs["test"]
    losses = [x for epoch in tr.losses for x in epoch]
    loop_params = trained_params(tr.state.model)
    del tr.state
    torch.cuda.empty_cache()
    direct, direct_params, step_s, step_clips, init = direct_data_steps(
        cfg, steps, AVA_STEPS)
    n_steps = len(steps)
    del steps
    torch.cuda.empty_cache()
    vs_direct = {
        "loss_rel_err_by_step": [abs(a - b) / abs(b)
                                 for a, b in zip(losses, direct)],
        "params_rel_l2": params_rel_l2(loop_params, direct_params),
        "update_rel_l2": params_rel_l2(
            {k: loop_params[k] - init[k] for k in init},
            {k: direct_params[k] - init[k] for k in init}),
        "first_loss_bit_equal": losses[0] == direct[0]}
    test_keyframes = len(build_dataset("ava", cfg, "test"))
    keys = te.meter.all_keys
    pad_rows = te.batches * AVA_BATCH - test_keyframes
    maps = [s["map"] for s in tr.val_stats] + [te.stats["map"]]
    host = {split: host_ms_per_clip(cfg, "ava", split, readers)
            for split in ("train", "test")}
    result = {
        "yaml": "configs/" + AVA_YAMLS["slowfast"], "reductions": reductions,
        "train": {"steps": tr.steps, "clips": tr.clips, "losses": tr.losses,
                  "val_stats": tr.val_stats, "val_clips": tr.val_clips,
                  "checkpoint_seconds": tr.checkpoint_seconds,
                  "train_loop_clips_per_sec": tr.clips / tr.seconds,
                  "step_clips_per_sec": step_clips / step_s,
                  "wait_share": tr.wait_seconds / tr.seconds,
                  "wait_share_without_first_batches":
                      (tr.wait_seconds - tr.first_wait_seconds) / tr.seconds,
                  "val_clips_per_sec": tr.val_clips / tr.val_seconds,
                  "loop_seconds": tr.seconds, "step_seconds": step_s,
                  "peak_memory_gb": train_peak, "launches": train_launches},
        "vs_direct_loop": vs_direct,
        "test": {"map": te.stats["map"],
                 "ap_classes": len(te.stats["ap_per_class"]),
                 "keyframes": test_keyframes, "scored": len(keys),
                 "distinct_keys": len(set(keys)), "batches": int(te.batches),
                 "pad_rows_dropped": pad_rows,
                 "test_loop_keyframes_per_sec": te.clips / te.seconds,
                 "wait_share": te.wait_seconds / te.seconds,
                 "peak_memory_gb": test_peak, "launches": test_launches},
        "host_ms_per_clip_read_excluded": host, "tools_seconds": tools_s}
    result["ok"] = (
        tr.steps == n_steps == 2 * AVA_STEPS
        and all(math.isfinite(x) for x in losses)
        and not any(train_launches.values())
        and not any(test_launches.values())
        and vs_direct["first_loss_bit_equal"]
        and max(vs_direct["loss_rel_err_by_step"]) <= TRAIN_LOOP_LOSS_REL
        and vs_direct["params_rel_l2"] <= TRAIN_LOOP_PARAM_REL
        and vs_direct["update_rel_l2"] <= DATA_LOOP_UPDATE_REL
        and len(tr.val_stats) == 2 and all(0.0 <= m <= 1.0 for m in maps)
        and te.clips == len(keys) == len(set(keys)) == test_keyframes
        and pad_rows > 0)
    return result


def ava_batch(cfg, gen, crop):
    """A detection batch on the card: clips [8, T, crop, crop, 3] (the
    yaml's pathways), 1-4 person boxes a clip in the crop's pixels (the
    rest of the 16 zero, masked), multi-hot labels of the valid ones."""
    from focus_tpu_torch.datasets.utils import pack_pathway_output

    rs = np.random.RandomState(int(torch.randint(1 << 30, (1,),
                                                 generator=gen)))
    video = rs.rand(cfg.DATA.NUM_FRAMES, AVA_BATCH, crop, crop, 3).astype(
        np.float32)
    paths = [torch.from_numpy(np.ascontiguousarray(p.swapaxes(0, 1))).to(DEV)
             for p in pack_pathway_output(cfg, video)]
    boxes = np.zeros((AVA_BATCH, 16, 4), np.float32)
    mask = np.zeros((AVA_BATCH, 16), np.float32)
    for b in range(AVA_BATCH):
        n = rs.randint(1, 5)
        xy = rs.rand(n, 2) * crop * 0.6
        boxes[b, :n] = np.concatenate([xy, xy + rs.rand(n, 2) * crop * 0.35
                                       + 8], axis=1)
        mask[b, :n] = 1.0
    labels = (rs.rand(AVA_BATCH, 16, cfg.MODEL.NUM_CLASSES) < 0.05) * mask[
        ..., None]
    video = paths[0] if len(paths) == 1 else paths
    return (video, torch.from_numpy(labels.astype(np.int32)).to(DEV),
            {"boxes": torch.from_numpy(boxes).to(DEV),
             "boxes_mask": torch.from_numpy(mask).to(DEV)})


def ava_mvit():
    """(b) configs/AVA/MVIT_16X4.yaml (MViT-B 16x4 with the RoI head, 80
    classes, bf16, the JAX package's initialisers) on a batch of 8: its
    eval forward (per-box probabilities [8, 16, 80]) and its SGD train step
    under the masked BCE, ms by CUDA events, peak memory, finite."""
    from focus_tpu_torch.config import get_cfg
    from focus_tpu_torch.engine import trainer
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.models.losses import get_loss_func

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", AVA_YAMLS["mvit"]))
    cfg.NUM_GPUS = 1
    model = build_model(cfg, DEV)
    gen = torch.Generator().manual_seed(3)
    video, labels, meta = ava_batch(cfg, gen, cfg.DATA.TRAIN_CROP_SIZE)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        probs = model(video, bboxes=meta["boxes"])
        eval_ms = time_ms(lambda: model(video, bboxes=meta["boxes"]),
                          warmup=1, iters=AVA_MVIT_ITERS)
    eval_peak = torch.cuda.max_memory_allocated() / 1e9
    state = trainer.build_supervised_state(cfg, model, 100)
    step = trainer.make_supervised_train_step(model, cfg, get_loss_func(cfg))
    model.train()
    torch.cuda.reset_peak_memory_stats()
    _, stats = step(state, video, labels, meta)
    loss = stats["loss"].item()
    step_ms = time_ms(lambda: step(state, video, labels, meta), warmup=1,
                      iters=AVA_MVIT_ITERS)
    step_peak = torch.cuda.max_memory_allocated() / 1e9
    result = {"yaml": "configs/" + AVA_YAMLS["mvit"], "batch": AVA_BATCH,
              "clip": list(video.shape), "probs_shape": list(probs.shape),
              "eval_ms": eval_ms, "eval_clips_per_sec": AVA_BATCH
              / (eval_ms / 1e3), "eval_peak_memory_gb": eval_peak,
              "step_ms": step_ms,
              "train_clips_per_sec": AVA_BATCH / (step_ms / 1e3),
              "step_peak_memory_gb": step_peak, "first_loss": loss,
              "stats_keys": sorted(stats)}
    result["ok"] = (list(probs.shape) == [AVA_BATCH, 16, AVA_CLASSES]
                    and bool(torch.isfinite(probs).all())
                    and float(probs.min()) >= 0.0
                    and float(probs.max()) <= 1.0 and math.isfinite(loss)
                    and sorted(stats) == ["loss"] and finite_grads(model))
    del model, state, step, video, labels, meta
    torch.cuda.empty_cache()
    return result


@torch.no_grad()
def ava_unaligned():
    """(c) configs/AVA/c2/SLOW_8x8_R50.yaml (DETECTION.ALIGNED False, the
    Caffe2 RoIAlign) at batch 8 on the 256 test crop: the bf16 eval
    forward's per-box probabilities against float32 on the same weights
    (AVA_PROB_REL of the largest)."""
    from focus_tpu_torch.config import get_cfg
    from focus_tpu_torch.models.build import build_model

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", AVA_YAMLS["slow_c2"]))
    cfg.NUM_GPUS = 1
    model = build_model(cfg, DEV)
    gen = torch.Generator().manual_seed(4)
    video, _, meta = ava_batch(cfg, gen, cfg.DATA.TEST_CROP_SIZE)
    probs = model(video, bboxes=meta["boxes"])
    ms = time_ms(lambda: model(video, bboxes=meta["boxes"]), warmup=1,
                 iters=AVA_MVIT_ITERS)
    dtype, model.dtype = model.dtype, torch.float32
    probs32 = model(video, bboxes=meta["boxes"])
    model.dtype = dtype
    valid = meta["boxes_mask"] > 0
    result = {"yaml": "configs/" + AVA_YAMLS["slow_c2"],
              "aligned": model.head.aligned, "clip": list(video.shape),
              "ms": ms, "probs_shape": list(probs.shape),
              "vs_float32": same_probs(probs[valid], probs32[valid],
                                       AVA_PROB_REL)}
    result["ok"] = (not model.head.aligned and result["vs_float32"]["ok"]
                    and bool(torch.isfinite(probs).all()))
    del model
    torch.cuda.empty_cache()
    return result


def phase_ava(smi):
    """Phase 20: AVA detection on the card (no hand-written kernel:
    ``F.conv3d``, the RoI head's plain RoIAlign; every launch count is
    checked to be 0). (a) SlowFast 32x2 R50 through ``tools.train_net``
    and ``tools.test_net`` over an in-script AVA tree with only the frame
    reads substituted; (b) MViT-B 16x4's AVA eval forward and train step;
    (c) the unaligned Caffe2 RoIAlign's forward against float32."""
    from focus_tpu_torch.utils import logging as port_logging

    shutil.rmtree(AVA_ENGINE_DIR, ignore_errors=True)
    result = {"phase": "ava", "gpu": smi}
    t0 = time.perf_counter()
    try:
        overrides = write_ava_tree(AVA_ENGINE_DIR)
        readers = AvaFrames()
        with open(AVA_ENGINE_LOG, "w") as log, contextlib.redirect_stdout(
                log), readers.installed():
            result["ava_slowfast_loops"] = ava_slowfast_loops(overrides,
                                                              readers)
        result["ava_mvit"] = ava_mvit()
        result["ava_unaligned"] = ava_unaligned()
    finally:
        port_logging.close_logging()
        shutil.rmtree(AVA_ENGINE_DIR, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t0
    parts = [v for v in result.values() if isinstance(v, dict) and "ok" in v]
    result["ok"] = len(parts) == 3 and all(v["ok"] for v in parts)
    emit(result)
    if not result["ok"]:
        failed = sorted(k for k, v in result.items()
                        if isinstance(v, dict) and not v.get("ok", True))
        raise AssertionError(f"AVA phase failed: {failed}")


# Data parallelism and multigrid (phase 21): the flagship train loop over
# torch.distributed, at world 1 through NCCL and at two ranks on the one
# card through gloo, against one process; then the Kinetics multigrid yaml
# through its long and short cycles. The package's logs go to DDP_LOG (and
# DDP_LOG's rank files for the spawned ranks), not to stdout.
DDP_DIR = os.path.join(REPO, "build", "ddp_engine")
DDP_LOG = os.path.join(REPO, "build", "ddp_engine.log")
DDP_BATCH = 8  # global batch: 4 a rank at two ranks
DDP_STEPS = 4  # one epoch
DDP_VAL = 12  # val clips: two batches, the second with 4 pad rows
DDP_TEST_VIDEOS = 4  # x 3 crops: 12 clips, two batches, 4 pad rows
DDP_RANKS = 2
# two ranks against one process on the same batches, bf16 on the card: each
# step's loss within this share of it (the first too: the same weights and
# batch, the microbatches and the BN-free model's rows split otherwise); the
# update |2-rank - 1-rank| / |1-rank - initial| (relative L2) within
# DDP_UPDATE_REL, phase 18's rule; the ensembled probabilities within
# DDP_ENSEMBLE_ATOL (phase 13's)
DDP_LOSS_REL = 1e-3
DDP_UPDATE_REL = 5e-2
DDP_ENSEMBLE_ATOL = 1e-3
MG_YAML = "Kinetics/SLOWFAST_8x8_R50_stepwise_multigrid.yaml"
# TRAIN.BATCH_SIZE (DEFAULT_B): the yaml's 64 over its NUM_GPUS 8, so the
# one card holds what each of the yaml's cards holds
MG_BATCH = 8
MG_EPOCH_FACTOR = 0.03  # cut from 1.5: the schedule ends at epoch 7
MG_TRAIN_CLIPS = 448  # one short cycle [256, 128, 64] at the largest B
MG_VAL_CLIPS = 8
MG_PRECISE = 2  # BN.NUM_BATCHES_PRECISE, cut from 200


class DDPTestClips(TestClips):
    VIDEOS = DDP_TEST_VIDEOS
    EK = False


def ddp_splits():
    """The flagship's in-script splits: TrainClips for train (one epoch)
    and val, DDPTestClips for test."""
    def make(cfg, mode):
        if mode == "test":
            return DDPTestClips(cfg, mode)
        return TrainClips(cfg, mode, DDP_BATCH * DDP_STEPS if mode == "train"
                          else DDP_VAL, False)

    return {"Chip_ddp_ssv2": make}


def ddp_cfg(out_dir, backend, accum):
    """Phase 14's flagship (entry.flagship_cfg with the SSv2 yaml's solver
    and drop path 0.2) with mixup on, at global batch DDP_BATCH under
    TPU.GRAD_ACCUM ``accum``: one epoch, one validation, then the test of
    DDP_TEST_VIDEOS x 3 crops."""
    from focus_tpu_torch.entry import flagship_cfg

    cfg = flagship_cfg()
    cfg.MODEL.ARCH = "slow"
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "chip_ddp_ssv2"
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = DDP_BATCH
    cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS = 1, 3
    cfg.TPU.GRAD_ACCUM = accum
    cfg.MIXUP.ENABLE = True
    s = cfg.SOLVER
    s.OPTIMIZING_METHOD, s.BASE_LR, s.WEIGHT_DECAY = "adamw", 5e-5, 5e-2
    s.LR_POLICY, s.LRS, s.STEPS = "steps_with_relative_lrs", [1, 0.1, 0.01], \
        [0, 20, 30]
    s.MAX_EPOCH, s.WARMUP_EPOCHS = 1, 0.0
    cfg.MF.DROP_PATH = 0.2
    cfg.TRAIN.EVAL_PERIOD = cfg.TRAIN.CHECKPOINT_PERIOD = 1
    cfg.TRAIN.AUTO_RESUME = False
    cfg.TENSORBOARD.ENABLE = False
    cfg.DATA_LOADER.NUM_WORKERS = 4
    cfg.LOG_PERIOD = 1
    cfg.DIST_BACKEND = backend
    cfg.NUM_GPUS = 1
    cfg.OUTPUT_DIR = out_dir
    return cfg


@contextlib.contextmanager
def timed_steps():
    """Every train step (``make_supervised_train_step``'s) and every
    gradient all-reduce (``parallel.mesh.all_reduce_mean_``, which the
    optimizer calls) between CUDA events; yields {"step": [ms],
    "all_reduce": [ms]}, filled at the exit."""
    from focus_tpu_torch.engine import trainer
    from focus_tpu_torch.parallel import mesh

    make, reduce_ = trainer.make_supervised_train_step, mesh.all_reduce_mean_
    events = {"step": [], "all_reduce": []}
    times = {"step": [], "all_reduce": []}

    def timed(fn, key):
        def run(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            events[key].append((start, end))
            return out

        return run

    trainer.make_supervised_train_step = lambda *a: timed(make(*a), "step")
    mesh.all_reduce_mean_ = timed(reduce_, "all_reduce")
    try:
        yield times
    finally:
        trainer.make_supervised_train_step, mesh.all_reduce_mean_ = \
            make, reduce_
        torch.cuda.synchronize()
        for key, pairs in events.items():
            times[key].extend(s.elapsed_time(e) for s, e in pairs)


def ddp_loop(cfg):
    """The flagship's train loop and test through ``tools.run_net``'s
    ``launch_job`` (a direct call: the process group, if any, is set up),
    each ``counted``; returns the runs, their launches, the step and
    all-reduce times, the initial parameters, and the meters' ensembles."""
    from focus_tpu_torch.engine import tester, trainer
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.tools import run_net

    init = host_params(build_model(cfg, DEV))  # as the loop builds it
    torch.cuda.empty_cache()
    runs = {"train": [], "test": []}
    with registered_splits(ddp_splits()), epoch_seeded_splits(), \
            captured_engine(runs), timed_steps() as times:
        run_net.launch_job(cfg, None, trainer.train, DEV)
        run_net.launch_job(cfg, None, tester.test, DEV)
    (run, launches, peak), = runs["train"]
    (test_run, test_launches, test_peak), = runs["test"]
    meter = test_run.meter
    out = {"losses": run.losses, "val_stats": run.val_stats,
           "val_clips": run.val_clips, "steps": run.steps, "clips": run.clips,
           "params": host_params(run.state.model), "init": init,
           "launches": launches, "test_launches": test_launches,
           "peak_memory_gb": peak, "test_peak_memory_gb": test_peak,
           "test_stats": test_run.stats, "test_clips": test_run.clips,
           "test_counted": int(meter.seen_clips.sum()),
           "ensembles": torch.from_numpy(np.asarray(meter.video_preds)),
           "step_ms": times["step"], "all_reduce_ms": times["all_reduce"]}
    del run, test_run
    torch.cuda.empty_cache()
    return out


def ddp_rank(local_rank, world, init_method, out_dir):
    """One of the two ranks on the one card (spawned): gloo, both on
    cuda:0, the loop of ``ddp_cfg`` under TPU.GRAD_ACCUM 2; its results to
    ``rank<r>.pt`` under ``out_dir``."""
    from focus_tpu_torch.parallel import mesh

    cfg = ddp_cfg(os.path.join(out_dir, "run"), "gloo", 2)
    mesh.init_distributed(cfg, local_rank, init_method, "cuda:0", world)
    try:
        with open(f"{DDP_LOG}.rank{local_rank}", "w") as log, \
                contextlib.redirect_stdout(log):
            result = ddp_loop(cfg)
        torch.save(result, os.path.join(out_dir, f"rank{local_rank}.pt"))
    finally:
        mesh.destroy()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mean_after_first(ms):
    return statistics.fmean(ms[1:]) if len(ms) > 1 else float("nan")


def ddp_launch_expect(steps, accum, val_batches, test_batches, per_call):
    depth = 12
    micro = steps * accum
    return ({"trajectory_block": depth * (micro + val_batches),
             "trajectory_block_bwd": depth * micro,
             "trajectory_block_bwd_device": depth * micro * per_call,
             "patch_embed": micro + val_batches},
            {"trajectory_block": depth * test_batches,
             "patch_embed": test_batches})


def launches_match(got, want):
    return all(got.get(k, 0) == want.get(k, 0) for k in set(got) | set(want))


def ddp_nccl_world1(per_call, problems):
    """(a): NCCL at world 1 on the card through ``init_distributed``: the
    gradient all-reduce, mixup's partner all-gather, the eval gathers and
    the stats' all-reduce go through NCCL."""
    from focus_tpu_torch.parallel import mesh

    cfg = ddp_cfg(os.path.join(DDP_DIR, "nccl"), "nccl", 1)
    device = mesh.init_distributed(cfg, 0, f"tcp://localhost:{_free_port()}",
                                   DEV, 1)
    try:
        backend = torch.distributed.get_backend()
        out = ddp_loop(cfg)
    finally:
        mesh.destroy()
    want, test_want = ddp_launch_expect(DDP_STEPS, 1, 2, 2, per_call)
    flat = [x for e in out["losses"] for x in e]
    ok = (backend == "nccl" and str(device) == "cuda:0"
          and launches_match(out["launches"], want)
          and launches_match(out["test_launches"], test_want)
          and out["steps"] == DDP_STEPS and all(map(math.isfinite, flat))
          and out["val_clips"] == DDP_VAL
          and out["test_counted"] == out["test_clips"] == 3 * DDP_TEST_VIDEOS
          and len(out["all_reduce_ms"]) == DDP_STEPS)
    if not ok:
        problems.append(f"NCCL world 1: backend {backend}, launches "
                        f"{out['launches']} / {out['test_launches']}, losses "
                        f"{flat}, clips {out['val_clips']} "
                        f"{out['test_counted']}")
    step = _mean_after_first(out["step_ms"])
    reduce_ = _mean_after_first(out["all_reduce_ms"])
    return out, {
        "backend": backend, "world": 1, "device": str(device),
        "batch": DDP_BATCH, "grad_accum": 1, "steps": out["steps"],
        "losses": flat, "val": out["val_stats"], "val_clips": out["val_clips"],
        "test_stats": out["test_stats"],
        "test_clips_counted": out["test_counted"],
        "launches_train_loop": out["launches"],
        "launches_test": out["test_launches"],
        "launches_per_train_step": {"trajectory_block": 12,
                                    "trajectory_block_bwd": 12,
                                    "patch_embed": 1},
        "step_ms": step, "all_reduce_ms": reduce_,
        "all_reduce_share_of_step": reduce_ / step,
        "peak_memory_gb": out["peak_memory_gb"]}


def ddp_two_ranks(per_call, problems):
    """(b): two ranks on the one card (gloo, both on cuda:0; NCCL refuses
    two ranks on one device) spawned here through ``init_distributed``, the
    loop at global batch DDP_BATCH (4 a rank) under mixup and TPU.GRAD_ACCUM
    2, against one process (no process group) on the same batches."""
    import torch.multiprocessing as mp

    out_dir = os.path.join(DDP_DIR, "gloo")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    mp.spawn(ddp_rank, nprocs=DDP_RANKS,
             args=(DDP_RANKS, f"tcp://localhost:{_free_port()}", out_dir))
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(DDP_RANKS)]
    cfg = ddp_cfg(os.path.join(DDP_DIR, "one"), "gloo", 2)
    one = ddp_loop(cfg)
    two = ranks[0]
    a = [x for e in two["losses"] for x in e]
    b = [x for e in one["losses"] for x in e]
    loss_rel = [abs(x - y) / abs(y) for x, y in zip(a, b)]
    init = one["init"]
    update = params_rel_l2({k: two["params"][k] - init[k] for k in init},
                           {k: one["params"][k] - init[k] for k in init})
    ens = (two["ensembles"] - one["ensembles"]).abs().max().item()
    same_ranks = all(torch.equal(ranks[1]["params"][k], two["params"][k])
                     for k in two["params"]) and ranks[1]["losses"] == \
        two["losses"]
    val_err = max(abs(two["val_stats"][0][k] - v)
                  for k, v in one["val_stats"][0].items() if k != "epoch")
    # each rank's kernels: its microbatches of 2 clips, its val and test
    # batches of 4 (every global batch's share)
    want, test_want = ddp_launch_expect(DDP_STEPS, 2, 2, 2, per_call)
    ok = (len(a) == len(b) == DDP_STEPS and max(loss_rel) <= DDP_LOSS_REL
          and update <= DDP_UPDATE_REL and ens <= DDP_ENSEMBLE_ATOL
          and same_ranks
          and all(r["val_clips"] == DDP_VAL for r in ranks)
          and all(r["test_counted"] == r["test_clips"] == 3 * DDP_TEST_VIDEOS
                  for r in ranks)
          and all(launches_match(r["launches"], want)
                  and launches_match(r["test_launches"], test_want)
                  for r in ranks)
          and launches_match(one["launches"], want))
    if not ok:
        problems.append(
            f"two ranks: losses {a} vs {b}, update {update:.3e}, ensembles "
            f"{ens:.3e}, ranks agree {same_ranks}, val {val_err}, launches "
            f"{[r['launches'] for r in ranks]} / {one['launches']}")
    step2 = _mean_after_first(two["step_ms"])
    reduce2 = _mean_after_first(two["all_reduce_ms"])
    return {
        "backend": "gloo", "world": DDP_RANKS, "device": "cuda:0 (both)",
        "global_batch": DDP_BATCH, "grad_accum": 2, "mixup": True,
        "losses_two_ranks": a, "losses_one_process": b,
        "first_loss_rel_err": loss_rel[0], "max_loss_rel_err": max(loss_rel),
        "update_rel_l2": update, "ensembles_max_abs_err": ens,
        "val_stats_max_abs_err": val_err, "ranks_bit_equal": same_ranks,
        "val_clips_counted": [r["val_clips"] for r in ranks],
        "test_clips_counted": [r["test_counted"] for r in ranks],
        "launches_train_loop_per_rank": [r["launches"] for r in ranks],
        "launches_test_per_rank": [r["test_launches"] for r in ranks],
        "step_ms_one_process": _mean_after_first(one["step_ms"]),
        "step_ms_two_ranks": step2, "all_reduce_ms_two_ranks": reduce2,
        "all_reduce_share_of_step": reduce2 / step2,
        "spawn_and_run_seconds": spawn_s,
        "rule": f"losses within {DDP_LOSS_REL} relative, update within "
                f"{DDP_UPDATE_REL}, ensembles within {DDP_ENSEMBLE_ATOL}"}


def multigrid_run(problems):
    """(c): configs/Kinetics/SLOWFAST_8x8_R50_stepwise_multigrid.yaml on
    one process through ``engine.trainer.run_train``, the file reads
    substituted (``InScriptReaders``) and cut so that every long-cycle
    (B, T, S) and the three short-cycle phases run: TRAIN.BATCH_SIZE
    MG_BATCH, MULTIGRID.EPOCH_FACTOR MG_EPOCH_FACTOR (the schedule's
    MAX_EPOCH 7), MG_TRAIN_CLIPS train clips an epoch, NUM_GPUS 1 (the
    card holds one of the yaml's 8 cards' share, so each shape takes the
    BN type and splits that each of those cards takes: sub_batchnorm at
    NUM_SPLITS 8, 4, 2 and batchnorm),
    BN.NUM_BATCHES_PRECISE MG_PRECISE, no test. Each step's LR held to
    ``epoch_lr_schedule`` on the rewritten config from the stage's (epoch,
    step); a line per shape."""
    from focus_tpu_torch.config import get_cfg
    from focus_tpu_torch.engine import trainer
    from focus_tpu_torch.models import optimizer as optim
    from focus_tpu_torch.models.norms import SubBatchNorm
    from focus_tpu_torch.utils.multigrid import (
        MultigridSchedule,
        get_current_long_cycle_shape,
    )

    root = os.path.join(DDP_DIR, "kinetics")
    os.makedirs(root)
    for split, n in (("train", MG_TRAIN_CLIPS), ("val", MG_VAL_CLIPS)):
        with open(os.path.join(root, f"{split}.csv"), "w") as f:
            f.write("".join(f"vid{k}.mp4 {k * 7 % 400}\n" for k in range(n)))
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", MG_YAML))
    cfg.DATA.PATH_TO_DATA_DIR = root
    cfg.TRAIN.BATCH_SIZE = MG_BATCH
    cfg.MULTIGRID.EPOCH_FACTOR = MG_EPOCH_FACTOR
    cfg.NUM_GPUS = 1
    cfg.BN.NUM_BATCHES_PRECISE = MG_PRECISE
    cfg.TEST.ENABLE = False
    cfg.TRAIN.AUTO_RESUME = False
    cfg.TENSORBOARD.ENABLE = False
    cfg.OUTPUT_DIR = os.path.join(DDP_DIR, "multigrid")
    ref = MultigridSchedule()
    ref_cfg = ref.init_multigrid(cfg.clone())
    epochs, lrs = [], []
    train_epoch, step_fn = trainer.train_epoch, optim.Optimizer.step
    make = trainer.make_supervised_train_step

    def spy_epoch(train_loader, state, train_step, train_meter, cur_epoch,
                  cfg_, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        record = {"epoch": cur_epoch, "B": cfg_.TRAIN.BATCH_SIZE,
                  "T": cfg_.DATA.NUM_FRAMES, "S": cfg_.DATA.TRAIN_CROP_SIZE,
                  "bn": cfg_.BN.NORM_TYPE, "num_splits": cfg_.BN.NUM_SPLITS,
                  "sub_batchnorm_layers": sum(
                      isinstance(m, SubBatchNorm)
                      for m in state.model.modules()),
                  "steps_per_epoch": len(train_loader),
                  "first_step": state.step, "ms": [], "batches": [],
                  "losses": []}
        epochs.append(record)
        out = train_epoch(train_loader, state, train_step, train_meter,
                          cur_epoch, cfg_, **kw)
        torch.cuda.synchronize()
        record["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        record["losses"] = out[1]
        return out

    def timed_make(model, cfg_, loss_fn):
        step = make(model, cfg_, loss_fn)

        def run(state, video, labels, metadata):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(state, video, labels, metadata)
            end.record()
            end.synchronize()
            epochs[-1]["ms"].append(start.elapsed_time(end))
            epochs[-1]["batches"].append(tuple(video[1].shape[:3]))
            return out

        return run

    def spy_step(self, count):
        out = step_fn(self, count)
        lrs.append((count, self.optimizer.param_groups[0]["lr"]))
        return out

    trainer.train_epoch, optim.Optimizer.step = spy_epoch, spy_step
    trainer.make_supervised_train_step = timed_make
    try:
        with InScriptReaders().installed():
            run = trainer.run_train(cfg, DEV)
    finally:
        trainer.train_epoch, optim.Optimizer.step = train_epoch, step_fn
        trainer.make_supervised_train_step = make
    # the LR each step should have: the rewritten config's schedule from
    # the (epoch, step) where its shape began
    expected, start, prev = {}, (0, 0), None
    for e in epochs:
        shape = tuple(get_current_long_cycle_shape(ref.schedule, e["epoch"]))
        if shape != prev:
            start, prev = (e["epoch"], e["first_step"]), shape
        sched = optim.epoch_lr_schedule(ref_cfg, e["steps_per_epoch"], "lr",
                                        float(start[0]), start[1])
        for k in range(e["first_step"], e["first_step"] + len(e["ms"])):
            expected[k] = sched(k)
    lr_ok = [c for c, _ in lrs] == list(range(run.state.step)) and all(
        lr == expected[c] for c, lr in lrs)
    flat = [x for e in epochs for x in e["losses"]]
    shapes = {tuple(s[1]) for s in ref.schedule}
    ran = {(e["B"] // MG_BATCH, e["T"], e["S"]) for e in epochs}
    # each epoch opens the short cycle: [4B, 2B, B] clips, crops 0.5 and
    # 0.71 x DEFAULT_S, then the stage's own
    cycles = all([b[0] for b in e["batches"][:3]] == [
        4 * e["B"], 2 * e["B"], e["B"]] and e["batches"][0][2] == round(
            0.5 * ref_cfg.MULTIGRID.DEFAULT_S) for e in epochs)
    # each epoch's BN type and splits: the schedule's rewrite, and the
    # model built with them
    want_bn, walk = {}, ref_cfg.clone()
    for epoch in range(ref_cfg.SOLVER.MAX_EPOCH):
        walk, _ = ref.update_long_cycle(walk, epoch)
        want_bn[epoch] = (walk.BN.NORM_TYPE, walk.BN.NUM_SPLITS)
    bn_ok = all((e["bn"], e["num_splits"]) == want_bn[e["epoch"]] and (
        e["sub_batchnorm_layers"] > 0) == (e["bn"] == "sub_batchnorm")
        for e in epochs)
    bn_types = {e["bn"] for e in epochs}
    ok = (lr_ok and all(map(math.isfinite, flat)) and ran == shapes
          and len(epochs) == ref_cfg.SOLVER.MAX_EPOCH and bn_ok
          and {"sub_batchnorm", "batchnorm"} <= bn_types and cycles)
    if not ok:
        problems.append(f"multigrid: lr {lr_ok}, shapes {sorted(ran)} of "
                        f"{sorted(shapes)}, bn {bn_types} as the schedule "
                        f"{bn_ok}, short cycles {cycles}, losses {flat}")
    per_shape = {}
    for e in epochs:
        key = (e["B"], e["T"], e["S"])
        row = per_shape.setdefault(key, {
            "B": e["B"], "T": e["T"], "S": e["S"], "bn": e["bn"],
            "num_splits": e["num_splits"],
            "sub_batchnorm_layers": e["sub_batchnorm_layers"],
            "epochs": [], "steps": 0, "ms": [], "short_cycle_batches": set(),
            "peak_memory_gb": 0.0})
        row["epochs"].append(e["epoch"])
        row["steps"] += len(e["ms"])
        row["ms"] += e["ms"][1:] if len(e["ms"]) > 1 else e["ms"]
        row["short_cycle_batches"] |= set(e["batches"])
        row["peak_memory_gb"] = max(row["peak_memory_gb"],
                                    e["peak_memory_gb"])
    lines = []
    for row in per_shape.values():
        row["ms_per_step"] = statistics.fmean(row.pop("ms"))
        row["short_cycle_batches"] = sorted(
            list(b) for b in row["short_cycle_batches"])
        lines.append(row)
    return {"yaml": f"configs/{MG_YAML}",
            "cuts": {"TRAIN.BATCH_SIZE": [64, MG_BATCH],
                     "MULTIGRID.EPOCH_FACTOR": [1.5, MG_EPOCH_FACTOR],
                     "SOLVER.MAX_EPOCH (rewritten)": [
                         None, ref_cfg.SOLVER.MAX_EPOCH],
                     "train clips an epoch": MG_TRAIN_CLIPS,
                     "val clips": MG_VAL_CLIPS, "NUM_GPUS": [8, 1],
                     "BN.NUM_BATCHES_PRECISE": [200, MG_PRECISE],
                     "TEST.ENABLE": [True, False]},
            "schedule": ref.schedule, "steps": run.steps,
            "lr_matches_schedule": lr_ok, "bn_matches_schedule": bn_ok,
            "losses_finite": all(
                map(math.isfinite, flat)), "short_cycles": cycles,
            "val": run.val_stats, "shapes": lines,
            "train_loop_seconds": run.seconds}


def phase_ddp(smi, per_call):
    """Phase 21: (a) NCCL at world 1, (b) two ranks on the one card against
    one process, (c) the Kinetics multigrid yaml. Returns the kernels'
    launches in (a) and in rank 0 of (b)."""
    from focus_tpu_torch.utils import logging as port_logging

    shutil.rmtree(DDP_DIR, ignore_errors=True)
    os.makedirs(DDP_DIR)
    problems = []
    result = {"phase": "ddp_multigrid", "gpu": smi}
    try:
        with open(DDP_LOG, "w") as log, contextlib.redirect_stdout(log):
            nccl, result["nccl_world_1"] = ddp_nccl_world1(per_call, problems)
            port_logging.close_logging()
            result["two_ranks_one_card"] = ddp_two_ranks(per_call, problems)
            result["multigrid"] = multigrid_run(problems)
    finally:
        port_logging.close_logging()
        shutil.rmtree(DDP_DIR, ignore_errors=True)
    two = result["two_ranks_one_card"]["launches_train_loop_per_rank"][0]
    result["ok"], result["problems"] = not problems, problems
    emit(result)
    if problems:
        raise AssertionError("ddp / multigrid phase failed")
    return {"nccl": nccl["launches"], "gloo_rank0": two}


# ---- phase 22: tensor and sequence parallelism, ZeRO-1, remat ---------------

MESH_DIR = os.path.join(REPO, "build", "mesh_engine")
MESH_LOG = os.path.join(REPO, "build", "mesh_engine.log")
MESH_YAML = os.path.join(REPO, "configs", "TPU",
                         "SSv2_ORViT-MF_224_16x4_dp_sp_tp.yaml")
MESH_RANKS = 8  # DATA 2 x SEQ 2 x MODEL 2, gloo, every rank on cuda:0
MESH_BATCH = 8  # global batch (the yaml's 48 cut so one card holds 8 ranks)
MESH_ACCUM = 2  # __graft_entry__._dryrun_multichip_impl's GRAD_ACCUM
MESH_STEPS = 3
MESH_VAL = 8  # val clips: one global batch
MESH_TEST_VIDEOS = 2  # x 3 crops: 6 clips, one batch with 2 pad rows
# against one process on the same batches, bf16 on the card (phase 21's
# gates): each loss within this share of it, the update's relative L2
# distance, the test ensembles
MESH_LOSS_REL = 1e-3
MESH_UPDATE_REL = 5e-2
MESH_ENSEMBLE_ATOL = 1e-3
WINDOW_CASES = ((8, 196), (8, 200), (4, 441))
WINDOW_SEQS = (2, 4)
REMAT_BATCH, REMAT_BIG_BATCH = 8, 16  # scripts/profile_train.py's pallas_b16r
REMAT_STEPS = 5
REMAT_GRAD_REL_L2 = 1e-3
HR_SEQ_PROB_ATOL = 1e-3


def window_kernels(problems):
    """(a): kernels 1 and 7 over each window of F / SEQ query frames
    (SEQ 2 and 4) at B = 8, N = 196 and 200, and B = 4, N = 441: the
    window's out, xs and q2 bit-equal to those rows of the whole launch;
    its dq within kernel 7's gate (``grad_errors``) of those rows of the
    whole launch's, and whether bit-equal; the windows' summed dK, dV,
    dWq2, dbq2 and dWk2 within the gate of the plain float32 backward of
    the whole core. The last window (f0 > 0) timed, forward and
    backward."""
    from focus_tpu_torch.ops import trajectory_block as tb

    heads, scale, C, F = 12, 64 ** -0.5, 768, 8
    gen = torch.Generator(device=DEV)
    gen.manual_seed(22)
    cases = []
    for B, N in WINDOW_CASES:
        S = F * N
        args = core_inputs(B, N, gen)
        q, kf, vf, wq2, bq2, wk2, _ = args
        dout = (torch.randn(B, S, C, generator=gen, device=DEV)
                * 0.1).bfloat16()
        out, xs, q2 = tb._launch(q, kf, vf, wq2, bq2, wk2, scale, heads)
        dq = tb._launch_backward(q, kf, vf, wq2, bq2, wk2, dout, xs, q2,
                                 scale, heads)[0]
        ref = tb.trajectory_core_backward_reference(
            *[a.float() for a in args], dout.float(), scale, heads)
        for seq in WINDOW_SEQS:
            n, tag = F // seq, f"B={B} N={N} SEQ={seq}"
            case = {"case": tag, "query_rows": n * N}
            sums, fwd_equal, dq_equal = None, True, True
            for w in range(seq):
                rows = slice(w * n * N, (w + 1) * n * N)
                qw = q[:, rows].contiguous()
                dw = dout[:, rows].contiguous()
                ow, xw, q2w = tb._launch(qw, kf, vf, wq2, bq2, wk2, scale,
                                         heads, f0=w * n)
                fwd_equal &= (torch.equal(ow, out[:, rows])
                              and torch.equal(xw, xs[:, rows])
                              and torch.equal(q2w, q2[:, rows]))
                g = tb._launch_backward(qw, kf, vf, wq2, bq2, wk2, dw, xw,
                                        q2w, scale, heads, f0=w * n)
                dq_equal &= torch.equal(g[0], dq[:, rows])
                case[f"dq_window_{w}"] = grad_errors(f"{tag} window {w} dq",
                                                     g[0], dq[:, rows])
                part = [x.float() for x in g[1:]]
                sums = part if sums is None else [
                    a + b for a, b in zip(sums, part)]
            for name, got, r in zip(GRAD_NAMES[1:], sums, ref[1:6]):
                case[f"summed_{name}"] = grad_errors(f"{tag} summed {name}",
                                                     got, r)
            case["out_xs_q2_bitwise_equal_to_whole_rows"] = fwd_equal
            case["dq_bitwise_equal_to_whole_rows"] = dq_equal
            if not fwd_equal:
                problems.append(f"window {tag}: out / xs / q2 differ from "
                                "the whole launch's rows")
            f0 = (seq - 1) * n
            qw = q[:, f0 * N:].contiguous()
            dw = dout[:, f0 * N:].contiguous()
            _, xw, q2w = tb._launch(qw, kf, vf, wq2, bq2, wk2, scale, heads,
                                    f0=f0)
            Sw = n * N
            fwd_bound = bound(core_flops(B, Sw, F, N, C),
                              nbytes(qw, kf, vf, wq2, bq2, wk2, qw, xw, q2w))
            bwd_bound = bound(core_bwd_flops(B, Sw, F, N, C, heads),
                              nbytes(qw, kf, vf, wq2, wk2, dw, xw, q2w)
                              + nbytes(qw, kf, vf) + 4 * (2 * C * C + C))
            case.update({
                "window_fwd_ms": time_ms(lambda: tb._launch(
                    qw, kf, vf, wq2, bq2, wk2, scale, heads, f0=f0)),
                "window_fwd_bound_ms": fwd_bound[0],
                "window_fwd_bound_by": fwd_bound[1],
                "window_bwd_ms": time_ms(lambda: tb._launch_backward(
                    qw, kf, vf, wq2, bq2, wk2, dw, xw, q2w, scale, heads,
                    f0=f0)),
                "window_bwd_bound_ms": bwd_bound[0],
                "window_bwd_bound_by": bwd_bound[1],
                "timed_window_f0": f0})
            cases.append(case)
            del qw, dw, xw, q2w
        del args, dout, out, xs, q2, dq, ref
        torch.cuda.empty_cache()
    return cases


def remat_train(remat, batch):
    """(TrainStep, inputs) of the flagship train step (``entry.train_cfg``
    with the yaml's drop path 0.2, which the recompute replays) from the
    seeded weights and batch, with or without TPU.REMAT."""
    from focus_tpu_torch import entry

    cfg = entry.train_cfg()
    cfg.MF.DROP_PATH = 0.2
    cfg.TPU.REMAT = remat
    return entry._train_entry(cfg, DEV, batch, 0)


def remat_run(remat, batch, grads=False):
    """The flagship train step at ``batch`` with or without TPU.REMAT, from
    the seeded weights and batch. With ``grads``, first one train forward
    and backward with drop path from a seeded generator: the loss, every
    gradient on the host, the generator's state after, the launches and
    the peak. Then REMAT_STEPS timed train steps (one warm-up): ms a step
    (CUDA events), peak allocated memory, and the device's busy ms and
    share of two steps under torch.profiler."""
    from focus_tpu_torch.models.losses import get_loss_func
    from focus_tpu_torch.ops.preprocess import device_normalize

    fn, inputs = remat_train(remat, batch)
    out = {}
    if grads:
        video, labels, boxes = inputs
        model, cfg = fn.model, fn.model.cfg
        model.train()
        gen = torch.Generator(device=DEV)
        gen.manual_seed(7)

        def run():
            logits = model(device_normalize(video, cfg),
                           {"orvit_bboxes": boxes}, train=True, generator=gen)
            loss = get_loss_func(cfg)(logits, labels)
            loss.backward()
            return loss.item()

        loss, launches, peak = counted(run)
        out = {"loss": loss, "generator": gen.get_state().cpu(),
               "grads": {n: p.grad.detach().float().cpu()
                         for n, p in model.named_parameters()
                         if p.grad is not None},
               "launches": launches, "peak_memory_gb": peak}
    fn(*inputs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: fn(*inputs), warmup=0, iters=REMAT_STEPS)
    step_peak = torch.cuda.max_memory_allocated() / 1e9
    busy = profiled_share(lambda: fn(*inputs))
    del fn, inputs
    torch.cuda.empty_cache()
    out["steps"] = {"remat": remat, "batch": batch, "step_ms": ms,
                    "peak_memory_gb": step_peak,
                    "profiled_wall_ms": busy["wall_ms_per_call"],
                    "device_busy_ms": busy.get("device_busy_ms_per_call",
                                               "not measured"),
                    "busy_share": busy["busy_share"]}
    return out


def remat_phase(problems):
    """(b): the flagship's train step at batch 8 with TPU.REMAT and
    without: the same loss, every gradient within REMAT_GRAD_REL_L2
    relative L2 (and whether bit-equal), the generator's state after the
    step equal, kernel 1 launched 12 + 7 times (blocks 2-5 and 7-9
    recomputed) and kernel 7 12 times; then ms a step and peak memory at
    batch 8 without and with remat and at batch 16 with it."""
    plain = remat_run(False, REMAT_BATCH, grads=True)
    remat = remat_run(True, REMAT_BATCH, grads=True)
    rel = {n: ((remat["grads"][n] - g).norm()
               / g.norm().clamp_min(1e-30)).item()
           for n, g in plain["grads"].items()}
    worst = max(rel, key=rel.get)
    bit_equal = all(torch.equal(remat["grads"][n], g)
                    for n, g in plain["grads"].items())
    same_gen = torch.equal(remat["generator"], plain["generator"])
    loss_rel = abs(remat["loss"] - plain["loss"]) / abs(plain["loss"])
    want = {"plain": (12, 12, 1), "remat": (19, 12, 1)}
    got = {k: (r["launches"]["trajectory_block"],
               r["launches"]["trajectory_block_bwd"],
               r["launches"]["patch_embed"])
           for k, r in (("plain", plain), ("remat", remat))}
    ok = (sorted(remat["grads"]) == sorted(plain["grads"])
          and loss_rel <= 1e-6 and rel[worst] <= REMAT_GRAD_REL_L2
          and same_gen and got == want)
    if not ok:
        problems.append(f"remat: loss {remat['loss']} vs {plain['loss']}, "
                        f"worst grad {worst} {rel[worst]:.3e}, generator "
                        f"{same_gen}, launches {got} (want {want})")
    runs = [plain["steps"], remat["steps"],
            remat_run(True, REMAT_BIG_BATCH)["steps"]]
    return {"loss_plain": plain["loss"], "loss_remat": remat["loss"],
            "loss_rel_err": loss_rel, "worst_grad": worst,
            "worst_grad_rel_l2": rel[worst], "grads_bitwise_equal": bit_equal,
            "generator_state_equal": same_gen,
            "launches_per_step": {k: dict(zip(
                ("trajectory_block", "trajectory_block_bwd", "patch_embed"),
                v)) for k, v in got.items()},
            "peak_memory_gb_one_step": {"plain": plain["peak_memory_gb"],
                                        "remat": remat["peak_memory_gb"]},
            "steps": runs,
            "rule": f"loss within 1e-6 relative, every gradient within "
                    f"{REMAT_GRAD_REL_L2} relative L2, the generator's state "
                    "equal, kernel 1 19 and kernel 7 12 launches a step "
                    "under remat"}


def mesh_splits():
    def make(cfg, mode):
        if mode == "test":
            return MeshTestClips(cfg, mode)
        return TrainClips(cfg, mode, MESH_BATCH * MESH_STEPS
                          if mode == "train" else MESH_VAL, False)

    return {"Chip_mesh_ssv2": make}


def mesh_cfg(out_dir, mesh_axes=True):
    """The dp x sp x tp yaml as shipped (the flagship recipe, drop path 0.2,
    no mixup, DATA -1 x SEQ 2 x MODEL 2) with the dry run's TPU.ZERO1 and
    GRAD_ACCUM 2, cut to global batch MESH_BATCH and MESH_STEPS steps of one
    epoch, one validation and the test of MESH_TEST_VIDEOS x 3 crops, in
    the in-script splits. ``mesh_axes=False``: the one-process run it is
    held against (no seq or model axis, no ZeRO-1)."""
    from focus_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(MESH_YAML)
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "chip_mesh_ssv2"
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = MESH_BATCH
    cfg.TRAIN.CHECKPOINT_FILE_PATH = ""
    cfg.TRAIN.AUTO_RESUME = False
    cfg.TRAIN.EVAL_PERIOD = cfg.TRAIN.CHECKPOINT_PERIOD = 1
    cfg.TRAIN.METHOD, cfg.TEST.EVAL_TASK = "sup", "ar"
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.TPU.GRAD_ACCUM = MESH_ACCUM
    cfg.TENSORBOARD.ENABLE = False
    cfg.DATA_LOADER.NUM_WORKERS = 2
    cfg.LOG_PERIOD = 1
    cfg.DIST_BACKEND = "gloo"
    cfg.OUTPUT_DIR = out_dir
    if mesh_axes:
        cfg.TPU.ZERO1 = True
        cfg.NUM_GPUS = MESH_RANKS
    else:
        cfg.TPU.MESH.SEQ = cfg.TPU.MESH.MODEL = 1
        cfg.NUM_GPUS = 1
    return cfg


class MeshTestClips(TestClips):
    VIDEOS = MESH_TEST_VIDEOS
    EK = False


@contextlib.contextmanager
def timed_collectives():
    """Every ``torch.distributed.all_reduce`` (gloo's CUDA tensors take
    every collective of the port as one) timed on the host clock between
    two synchronisations of the card, and each train step's share of them;
    yields {"all": [s], "step": [s a step]}."""
    import torch.distributed as dist

    from focus_tpu_torch.engine import trainer

    reduce_, make = dist.all_reduce, trainer.make_supervised_train_step
    times = {"all": [], "step": []}

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce_(*args, **kwargs)
        torch.cuda.synchronize()
        times["all"].append(time.perf_counter() - t0)
        return out

    def make_timed(*args):
        step = make(*args)

        def run(*a, **k):
            before = sum(times["all"])
            out = step(*a, **k)
            times["step"].append(sum(times["all"]) - before)
            return out

        return run

    dist.all_reduce, trainer.make_supervised_train_step = timed, make_timed
    try:
        yield times
    finally:
        dist.all_reduce, trainer.make_supervised_train_step = reduce_, make


def mesh_loop(cfg):
    """The yaml's train loop and test through ``tools.run_net.launch_job``
    (a process of a group calls them itself), each ``counted``: the runs'
    results, the full parameters before and after (gathered over the model
    line), this rank's bytes, step and collective times."""
    from focus_tpu_torch.engine import tester, trainer
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.parallel import mesh, tensor
    from focus_tpu_torch.tools import run_net

    init = {k: v.float().cpu() for k, v in tensor.full_state_dict(
        build_model(cfg, DEV)).items()}
    torch.cuda.empty_cache()
    runs = {"train": [], "test": []}
    with registered_splits(mesh_splits()), epoch_seeded_splits(), \
            captured_engine(runs), timed_collectives() as collective_s, \
            timed_steps() as times:
        run_net.launch_job(cfg, None, trainer.train, DEV)
        run_net.launch_job(cfg, None, tester.test, DEV)
    (run, launches, peak), = runs["train"]
    (test_run, test_launches, test_peak), = runs["test"]
    meter = test_run.meter
    out = {"losses": run.losses, "val_clips": run.val_clips,
           "steps": run.steps, "init": init,
           "params": {k: v.float().cpu() for k, v in
                      tensor.full_state_dict(run.state.model).items()},
           "bytes": trainer.state_bytes(run.state),
           "launches": launches, "test_launches": test_launches,
           "peak_memory_gb": peak, "test_peak_memory_gb": test_peak,
           "test_clips": test_run.clips,
           "test_counted": int(meter.seen_clips.sum()),
           "ensembles": torch.from_numpy(np.asarray(meter.video_preds)),
           "step_ms": times["step"],
           "step_collective_ms": [1e3 * t for t in collective_s["step"]],
           "collective_ms": 1e3 * sum(collective_s["all"]),
           "collectives": len(collective_s["all"]),
           "rank": mesh.rank(),
           "coords": (mesh.data_rank(), mesh.seq_rank(), mesh.model_rank())}
    del run, test_run
    torch.cuda.empty_cache()
    return out


def mesh_rank(local_rank, world, init_method, out_dir, job):
    """One rank of phase 22 on the one card (spawned, gloo on cuda:0):
    ``job`` "yaml" runs ``mesh_loop`` on the yaml's mesh, "hr" the HR-336
    eval forward under SEQ 2; results to ``<job>_rank<r>.pt``."""
    from focus_tpu_torch.parallel import mesh

    cfg = (mesh_cfg(os.path.join(out_dir, "run")) if job == "yaml"
           else hr_seq_cfg())
    mesh.init_distributed(cfg, local_rank, init_method,
                          "cuda:0" if DEV == "cuda" else DEV, world)
    try:
        with open(f"{MESH_LOG}.{job}.rank{local_rank}", "w") as log, \
                contextlib.redirect_stdout(log):
            result = mesh_loop(cfg) if job == "yaml" else hr_seq_eval(cfg)
        torch.save(result, os.path.join(out_dir, f"{job}_rank{local_rank}.pt"))
    finally:
        mesh.destroy()


def split_and_whole_bytes(cfg, model_size):
    """(bytes of the leaves a model axis of ``model_size`` splits, bytes of
    all leaves) of the whole model."""
    import focus_tpu_torch.models.motionformer  # noqa: F401 (registration)
    from focus_tpu_torch.models.build import MODEL_REGISTRY
    from focus_tpu_torch.parallel import tensor

    with torch.device("meta"):
        model = MODEL_REGISTRY[cfg.MODEL.MODEL_NAME](cfg)
    split = whole = 0
    for name, p in model.named_parameters():
        b = p.numel() * 4
        whole += b
        if tensor.param_dim(name, p.shape, model_size) is not None:
            split += b
    return split, whole


def mesh_yaml_run(per_call, problems):
    """(c): the yaml's mesh as MESH_RANKS gloo ranks on cuda:0 against one
    process on the same batches; the checkpoint the ranks write loaded in
    one process."""
    import torch.multiprocessing as mp

    from focus_tpu_torch.engine.trainer import build_supervised_state
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.utils import checkpoint as cu

    out_dir = os.path.join(MESH_DIR, "yaml")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    mp.spawn(mesh_rank, nprocs=MESH_RANKS,
             args=(MESH_RANKS, f"tcp://localhost:{_free_port()}", out_dir,
                   "yaml"))
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"yaml_rank{r}.pt"),
                        weights_only=False) for r in range(MESH_RANKS)]
    one_cfg = mesh_cfg(os.path.join(MESH_DIR, "one"), mesh_axes=False)
    one = mesh_loop(one_cfg)
    r0 = ranks[0]
    a = [x for e in r0["losses"] for x in e]
    b = [x for e in one["losses"] for x in e]
    loss_rel = [abs(x - y) / abs(y) for x, y in zip(a, b)]
    init = one["init"]
    init_same = all(torch.equal(r0["init"][k], v) for k, v in init.items())
    update = params_rel_l2({k: r0["params"][k] - init[k] for k in init},
                           {k: one["params"][k] - init[k] for k in init})
    ens = (r0["ensembles"] - one["ensembles"]).abs().max().item()
    same_ranks = all(torch.equal(r["params"][k], r0["params"][k])
                     for r in ranks[1:] for k in r0["params"])
    # the checkpoint rank 0 wrote, loaded in one process bit for bit
    path = cu.get_last_checkpoint(os.path.join(out_dir, "run"))
    payload = cu.read_payload(path)
    model = build_model(one_cfg, DEV)
    state = build_supervised_state(one_cfg, model, MESH_STEPS)
    cu.restore_train_state(payload, state)
    loaded = (all(torch.equal(v.cpu(), payload["model_state"][k])
                  for k, v in model.state_dict().items())
              and all(torch.equal(payload["model_state"][k].float(), v)
                      for k, v in r0["params"].items()))
    opt = state.optimizer.state_dict()["state"]
    saved = payload["optimizer_state"]["state"]
    loaded = loaded and sorted(opt) == sorted(saved) and all(
        torch.equal(opt[i][k].cpu(), saved[i][k])
        for i in saved for k in saved[i] if torch.is_tensor(saved[i][k]))
    del model, state, payload
    torch.cuda.empty_cache()
    split, whole = split_and_whole_bytes(one_cfg, 2)
    groups = 2  # the flagship's main and zero-decay groups
    bytes_ok = all(r["bytes"]["param_bytes"] == whole - split // 2 and
                   r["bytes"]["param_bytes"] <= r["bytes"]["optimizer_bytes"]
                   <= r["bytes"]["param_bytes"] + groups * 12
                   for r in ranks)
    val_batches = -(-MESH_VAL // MESH_BATCH)
    test_batches = -(-3 * MESH_TEST_VIDEOS // MESH_BATCH)
    want, test_want = ddp_launch_expect(MESH_STEPS, MESH_ACCUM, val_batches,
                                        test_batches, per_call)
    ok = (len(a) == len(b) == MESH_STEPS and init_same
          and max(loss_rel) <= MESH_LOSS_REL and update <= MESH_UPDATE_REL
          and ens <= MESH_ENSEMBLE_ATOL and same_ranks and loaded
          and bytes_ok
          and all(r["val_clips"] == MESH_VAL for r in ranks)
          and all(r["test_counted"] == r["test_clips"] == 3 * MESH_TEST_VIDEOS
                  for r in ranks)
          and all(launches_match(r["launches"], want)
                  and launches_match(r["test_launches"], test_want)
                  for r in ranks)
          and launches_match(one["launches"], want))
    if not ok:
        problems.append(
            f"yaml mesh: losses {a} vs {b}, init equal {init_same}, update "
            f"{update:.3e}, ensembles {ens:.3e}, ranks agree {same_ranks}, "
            f"checkpoint loads {loaded}, bytes {[r['bytes'] for r in ranks]} "
            f"(split {split}, whole {whole}), val "
            f"{[r['val_clips'] for r in ranks]}, test "
            f"{[(r['test_counted'], r['test_clips']) for r in ranks]}, "
            f"launches {[r['launches'] for r in ranks]} / {one['launches']}")
    step = [_mean_after_first(r["step_ms"]) for r in ranks]
    return {
        "backend": "gloo", "world": MESH_RANKS, "device": "cuda:0 (all)",
        "mesh": "DATA 2 x SEQ 2 x MODEL 2", "zero1": True,
        "grad_accum": MESH_ACCUM, "global_batch": MESH_BATCH, "mixup": False,
        "losses_mesh": a, "losses_one_process": b,
        "first_loss_rel_err": loss_rel[0], "max_loss_rel_err": max(loss_rel),
        "update_rel_l2": update, "ensembles_max_abs_err": ens,
        "ranks_bit_equal": same_ranks, "checkpoint_loads_bitwise": loaded,
        "val_clips_counted": [r["val_clips"] for r in ranks],
        "test_clips_counted": [r["test_counted"] for r in ranks],
        "per_rank": [{
            "rank": r["rank"], "data_seq_model": r["coords"],
            "peak_memory_gb": r["peak_memory_gb"],
            "test_peak_memory_gb": r["test_peak_memory_gb"],
            "param_bytes": r["bytes"]["param_bytes"],
            "optimizer_bytes": r["bytes"]["optimizer_bytes"],
            "launches_train_loop": r["launches"],
            "launches_test": r["test_launches"],
            "step_ms": _mean_after_first(r["step_ms"]),
            "step_collective_ms": _mean_after_first(r["step_collective_ms"]),
            "loop_collective_ms": r["collective_ms"],
            "loop_collectives": r["collectives"]} for r in ranks],
        "one_process": {"peak_memory_gb": one["peak_memory_gb"],
                        "param_bytes": one["bytes"]["param_bytes"],
                        "optimizer_bytes": one["bytes"]["optimizer_bytes"],
                        "step_ms": _mean_after_first(one["step_ms"]),
                        "launches_train_loop": one["launches"]},
        "whole_param_bytes": whole, "split_param_bytes": split,
        "step_ms_mesh_rank0": step[0],
        "collective_share_of_step_rank0": (
            _mean_after_first(r0["step_collective_ms"])
            / _mean_after_first(r0["step_ms"])),
        "collective_note": "host ms inside torch.distributed.all_reduce "
                           "(every collective under gloo's CUDA tensors), "
                           "between synchronisations of the card, within "
                           "each train step (after the first), against the "
                           "step's CUDA-event time; loop_ counts the whole "
                           "train loop, validation and test; gloo through "
                           "the host with 8 ranks on one card: no "
                           "multi-card time",
        "spawn_and_run_seconds": spawn_s,
        "rule": f"losses within {MESH_LOSS_REL} relative, update within "
                f"{MESH_UPDATE_REL}, ensembles within {MESH_ENSEMBLE_ATOL}, "
                "every val and test clip counted once on every rank, the "
                "checkpoint loads in one process bit for bit, the split "
                "leaves' bytes halved, the moments halved up to padding"}


def hr_seq_cfg():
    from focus_tpu_torch.entry import hr_cfg

    cfg = hr_cfg()
    cfg.TPU.MESH.SEQ = 2
    cfg.NUM_GPUS = 2
    cfg.DIST_BACKEND = "gloo"
    return cfg


def hr_seq_eval(cfg):
    """The HR-336 eval forward at batch HR_BATCH (entry._eval_entry's
    weights and inputs) on this rank: probabilities on the host, launches
    and peak memory."""
    from focus_tpu_torch import entry

    fn, (video, boxes) = entry._eval_entry(cfg, DEV, HR_BATCH, 0)
    (verb, both), launches, peak = counted(lambda: fn(video, boxes))
    out = {"verb": both["verb"].float().cpu(),
           "noun": both["noun"].float().cpu(), "launches": launches,
           "peak_memory_gb": peak}
    del fn, video, boxes
    torch.cuda.empty_cache()
    return out


def hr_seq_run(problems):
    """(d): the HR-336 eval under SEQ 2 as two gloo ranks on cuda:0 against
    one process: the probabilities within HR_SEQ_PROB_ATOL, each rank's
    peak memory beside one process's."""
    import torch.multiprocessing as mp

    out_dir = os.path.join(MESH_DIR, "hr")
    os.makedirs(out_dir, exist_ok=True)
    mp.spawn(mesh_rank, nprocs=2,
             args=(2, f"tcp://localhost:{_free_port()}", out_dir, "hr"))
    ranks = [torch.load(os.path.join(out_dir, f"hr_rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    cfg = hr_seq_cfg()
    cfg.TPU.MESH.SEQ, cfg.NUM_GPUS = 1, 1
    one = hr_seq_eval(cfg)
    err = max((r[k] - one[k]).abs().max().item()
              for r in ranks for k in ("verb", "noun"))
    want = {"trajectory_block": 12, "patch_embed": 1}
    ok = err <= HR_SEQ_PROB_ATOL and all(
        launches_match(r["launches"], want) for r in ranks) and \
        launches_match(one["launches"], want)
    if not ok:
        problems.append(f"HR-336 SEQ 2: probabilities {err:.3e}, launches "
                        f"{[r['launches'] for r in ranks]} / "
                        f"{one['launches']}")
    return {"batch": HR_BATCH, "probs_max_abs_err": err,
            "peak_memory_gb_per_rank": [r["peak_memory_gb"] for r in ranks],
            "peak_memory_gb_one_process": one["peak_memory_gb"],
            "launches_per_rank": [r["launches"] for r in ranks],
            "rule": f"verb and noun probabilities within {HR_SEQ_PROB_ATOL}"}


def phase_mesh(smi, per_call):
    """Phase 22: (a) kernels 1 and 7 over windows of query frames, (b)
    remat on one process, (c) the dp x sp x tp yaml's mesh on the card,
    (d) HR-336 eval under SEQ 2. Returns the windows' cases and the
    launches of (b)-(d)."""
    from focus_tpu_torch.utils import logging as port_logging

    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    problems = []
    result = {"phase": "mesh", "gpu": smi}
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name], t0 = time.perf_counter() - t0, time.perf_counter()

    try:
        result["windows"] = window_kernels(problems)
        lap("windows")
        with open(MESH_LOG, "w") as log, contextlib.redirect_stdout(log):
            result["remat"] = remat_phase(problems)
            lap("remat")
            result["yaml_mesh"] = mesh_yaml_run(per_call, problems)
            lap("yaml_mesh")
            port_logging.close_logging()
            result["hr336_seq2"] = hr_seq_run(problems)
            lap("hr336_seq2")
    finally:
        result["seconds"] = seconds
        port_logging.close_logging()
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    result["ok"], result["problems"] = not problems, problems
    emit(result)
    if problems:
        raise AssertionError("mesh phase failed")
    rank0 = result["yaml_mesh"]["per_rank"][0]
    return {"windows": result["windows"],
            "remat": result["remat"]["launches_per_step"]["remat"],
            "mesh_rank0": rank0["launches_train_loop"],
            "hr_seq_rank0": result["hr336_seq2"]["launches_per_rank"][0]}


# ---- phase 23: pipeline and expert parallelism -------------------------------

PP_DIR = os.path.join(REPO, "build", "pp_engine")
PP_LOG = os.path.join(REPO, "build", "pp_engine.log")
PP_YAML = os.path.join(REPO, "configs", "TPU", "SSv2_MF_224_16x4_pp_moe.yaml")
PP_RANKS = 8  # DATA 2 x PIPE 2 x EXPERT 2, gloo, every rank on cuda:0
PP_DATA = 2  # the data ranks the one-process reference plays
PP_BATCH = 8  # global train and test batch (the yaml's 48 and 64 cut so
# one card holds 8 ranks)
PP_STEPS = 3
PP_VAL = 8  # val clips: one global batch
PP_TEST_VIDEOS = 2  # x 3 crops: 6 clips, one batch with 2 pad rows
PP_FLAGSHIP_STEPS = 2
PP_EVAL_ATOL = 1e-3


def pp_splits():
    def make(cfg, mode):
        if mode == "test":
            return PPTestClips(cfg, mode)
        return TrainClips(cfg, mode, PP_BATCH * PP_STEPS
                          if mode == "train" else PP_VAL, False)

    return {"Chip_pp_ssv2": make}


class PPTestClips(TestClips):
    VIDEOS = PP_TEST_VIDEOS
    EK = False


def pp_cfg(out_dir, ranks=PP_RANKS):
    """The pp_moe yaml as shipped (DATA -1 x PIPE 2 x EXPERT 2, 4
    microbatches, 4 Switch experts, drop path 0.2), cut to global batch
    PP_BATCH and PP_STEPS steps of one epoch, one validation and the test
    of PP_TEST_VIDEOS x 3 crops, in the in-script splits, on ``ranks`` gloo
    processes (1: the one-process pipelined model, every stage and
    expert)."""
    from focus_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(PP_YAML)
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "chip_pp_ssv2"
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = PP_BATCH
    cfg.TRAIN.CHECKPOINT_FILE_PATH = ""
    cfg.TRAIN.AUTO_RESUME = False
    cfg.TRAIN.EVAL_PERIOD = cfg.TRAIN.CHECKPOINT_PERIOD = 1
    cfg.TRAIN.METHOD, cfg.TEST.EVAL_TASK = "sup", "ar"
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.TENSORBOARD.ENABLE = False
    cfg.DATA_LOADER.NUM_WORKERS = 2
    cfg.LOG_PERIOD = 1
    cfg.DIST_BACKEND = "gloo"
    cfg.OUTPUT_DIR = out_dir
    cfg.NUM_GPUS = ranks
    return cfg


@contextlib.contextmanager
def recorded_pipe():
    """Each train step's stats on the host, and the host seconds (between
    synchronisations of the card) of the pipeline's hand-offs
    (``parallel/pipeline._exchange`` and ``_broadcast``) and of the expert
    gathers and copy-ins (``parallel/tensor._all_gather`` / ``_all_reduce``,
    which nothing else calls without a model axis) within each step; yields
    {"stats": [...], "handoff_s": [...], "expert_s": [...]}."""
    from focus_tpu_torch.engine import trainer
    from focus_tpu_torch.parallel import pipeline
    from focus_tpu_torch.parallel import tensor as tp

    saved = {(pipeline, "_exchange"): pipeline._exchange,
             (pipeline, "_broadcast"): pipeline._broadcast,
             (tp, "_all_gather"): tp._all_gather,
             (tp, "_all_reduce"): tp._all_reduce,
             (trainer, "make_supervised_train_step"):
                 trainer.make_supervised_train_step}
    out = {"stats": [], "handoff_s": [], "expert_s": []}
    acc = {"handoff": 0.0, "expert": 0.0}

    def timed(fn, key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            acc[key] += time.perf_counter() - t0
            return result

        return run

    def make(*args):
        step = saved[(trainer, "make_supervised_train_step")](*args)

        def run(*a, **k):
            acc["handoff"] = acc["expert"] = 0.0
            state, stats = step(*a, **k)
            out["stats"].append({k: float(v) for k, v in stats.items()})
            out["handoff_s"].append(acc["handoff"])
            out["expert_s"].append(acc["expert"])
            return state, stats

        return run

    pipeline._exchange = timed(saved[(pipeline, "_exchange")], "handoff")
    pipeline._broadcast = timed(saved[(pipeline, "_broadcast")], "handoff")
    tp._all_gather = timed(saved[(tp, "_all_gather")], "expert")
    tp._all_reduce = timed(saved[(tp, "_all_reduce")], "expert")
    trainer.make_supervised_train_step = make
    try:
        yield out
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def pp_loop(cfg, virtual=1):
    """The yaml's train loop and test, each ``counted``: through
    ``tools.run_net.launch_job`` on a process of the group, or, in one
    process, ``trainer.train`` and ``tester.test`` called directly under
    ``mesh.single_process_mesh(virtual)`` (``run_net`` keeps the JAX
    package's refusal of a world the axes do not divide). Returns the runs' results,
    the full parameters before and after (rank 0 and one process; every
    rank their digests), this rank's bytes, the steps' stats and times."""
    from focus_tpu_torch.engine import tester, trainer
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.parallel import mesh, tensor
    from focus_tpu_torch.tools import run_net

    one = not mesh.is_distributed()

    def whole():
        return (mesh.single_process_mesh(virtual) if one
                else contextlib.nullcontext())

    keep = mesh.rank() == 0  # the host copies rank 0 returns (memory)
    with whole():
        full = tensor.full_state_dict(build_model(cfg, DEV))
        init = ({k: v.float().cpu().clone() for k, v in full.items()}
                if keep else None)
        del full
    torch.cuda.empty_cache()
    runs = {"train": [], "test": []}
    with registered_splits(pp_splits()), epoch_seeded_splits(), \
            captured_engine(runs), timed_steps() as times, \
            recorded_pipe() as pipe, whole():
        if one:
            trainer.train(cfg, DEV)
            tester.test(cfg, DEV)
        else:
            run_net.launch_job(cfg, None, trainer.train, DEV)
            run_net.launch_job(cfg, None, tester.test, DEV)
    (run, launches, peak), = runs["train"]
    (test_run, test_launches, test_peak), = runs["test"]
    meter = test_run.meter
    params, digest = {}, {}
    for k, v in tensor.full_state_dict(run.state.model).items():
        v = v.float().cpu()
        digest[k] = hashlib.sha1(v.numpy().tobytes()).hexdigest()
        if keep:
            params[k] = v
    out = {"losses": run.losses, "val_clips": run.val_clips,
           "steps": run.steps, "init": init,
           "params": params if keep else None, "digest": digest,
           "bytes": trainer.state_bytes(run.state),
           "launches": launches, "test_launches": test_launches,
           "peak_memory_gb": peak, "test_peak_memory_gb": test_peak,
           "test_clips": test_run.clips,
           "test_counted": int(meter.seen_clips.sum()),
           "ensembles": torch.from_numpy(np.asarray(meter.video_preds)),
           "step_ms": times["step"], "stats": pipe["stats"],
           "handoff_ms": [1e3 * t for t in pipe["handoff_s"]],
           "expert_ms": [1e3 * t for t in pipe["expert_s"]],
           "rank": mesh.rank(),
           "coords": (mesh.data_rank(), mesh.pipe_rank(),
                      mesh.expert_rank())}
    del run, test_run
    torch.cuda.empty_cache()
    return out


def pp_flagship_cfg(ranks):
    """The ORViT-MF flagship's train config under PIPE 2 and 4
    microbatches (blocks 2-5 pipelined; the rest replicated), on ``ranks``
    gloo processes."""
    from focus_tpu_torch.entry import train_cfg

    cfg = train_cfg()
    cfg.TPU.MESH.PIPE = 2
    cfg.TPU.MESH.PIPE_MICROBATCHES = 4
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = PP_BATCH
    cfg.NUM_GPUS = ranks
    cfg.DIST_BACKEND = "gloo"
    return cfg


def pp_flagship_steps(cfg):
    """PP_FLAGSHIP_STEPS direct train steps of the flagship (its seeded
    init, ``entry.example_inputs``' batch of PP_BATCH) on this rank, or in
    one process the whole pipelined model: the losses, the full parameters
    before and after, the launches and peak memory."""
    from focus_tpu_torch.engine.trainer import (
        build_supervised_state,
        make_supervised_train_step,
    )
    from focus_tpu_torch.entry import example_inputs
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.models.losses import get_loss_func
    from focus_tpu_torch.parallel import mesh, tensor

    whole = (mesh.single_process_mesh() if not mesh.is_distributed()
             else contextlib.nullcontext())
    with whole:
        model = build_model(cfg, DEV, seed=0)
        state = build_supervised_state(cfg, model, 100)
        step = make_supervised_train_step(model, cfg, get_loss_func(cfg))
    init = {k: v.float().cpu().clone() for k, v in
            tensor.full_state_dict(model).items()}
    video, labels, boxes = example_inputs(cfg, PP_BATCH, 0, DEV, labels=True)
    n = PP_BATCH // mesh.data_size()
    rows = slice(mesh.data_rank() * n, (mesh.data_rank() + 1) * n)
    model.train()

    def run():
        nonlocal state
        losses = []
        for _ in range(PP_FLAGSHIP_STEPS):
            state, stats = step(state, video[rows], labels[rows],
                                {"orvit_bboxes": boxes[rows]})
            losses.append(float(stats["loss"]))
        return losses

    losses, launches, peak = counted(run)
    out = {"losses": losses, "init": init, "launches": launches,
           "peak_memory_gb": peak,
           "params": {k: v.float().cpu() for k, v in
                      tensor.full_state_dict(model).items()}}
    del model, state
    torch.cuda.empty_cache()
    return out


def pp_rank(local_rank, world, init_method, out_dir, job):
    """One rank of phase 23 on the one card (spawned, gloo on cuda:0):
    ``job`` "yaml" runs ``pp_loop`` on the pp_moe yaml's mesh, "flagship"
    the flagship's train steps under PIPE 2, "one" the yaml's one-process
    reference (no process group, playing PP_DATA data ranks, with the
    cuBLAS workspace the mesh's ranks fix, ``parallel/mesh.set_axes``);
    results to ``<job>_rank<r>.pt``."""
    from focus_tpu_torch.parallel import mesh

    if job == "one":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        with open(f"{PP_LOG}.one", "w") as log, \
                contextlib.redirect_stdout(log):
            result = pp_loop(pp_cfg(os.path.join(out_dir, "run"), ranks=1),
                             PP_DATA)
        torch.save(result, os.path.join(out_dir, "one_rank0.pt"))
        return
    cfg = (pp_cfg(os.path.join(out_dir, "run")) if job == "yaml"
           else pp_flagship_cfg(world))
    mesh.init_distributed(cfg, local_rank, init_method,
                          "cuda:0" if DEV == "cuda" else DEV, world)
    try:
        with open(f"{PP_LOG}.{job}.rank{local_rank}", "w") as log, \
                contextlib.redirect_stdout(log):
            result = pp_loop(cfg) if job == "yaml" else pp_flagship_steps(cfg)
        torch.save(result, os.path.join(out_dir, f"{job}_rank{local_rank}.pt"))
    finally:
        mesh.destroy()


def pp_spawn(job, world):
    import torch.multiprocessing as mp

    out_dir = os.path.join(PP_DIR, job)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    mp.spawn(pp_rank, nprocs=world,
             args=(world, f"tcp://localhost:{_free_port()}", out_dir, job))
    spawn_s = time.perf_counter() - t0
    return out_dir, spawn_s, [torch.load(
        os.path.join(out_dir, f"{job}_rank{r}.pt"), weights_only=False)
        for r in range(world)]


def pp_bytes(cfg, pipe, expert):
    """(whole model's parameter bytes, what a rank of ``pipe`` stages and
    ``expert`` expert shards holds: every replicated leaf, its stage's
    blocks, its share of their experts)."""
    import focus_tpu_torch.models.motionformer  # noqa: F401 (registration)
    from focus_tpu_torch.models.build import MODEL_REGISTRY
    from focus_tpu_torch.parallel import pipeline, tensor

    with torch.device("meta"):
        model = MODEL_REGISTRY[cfg.MODEL.MODEL_NAME](cfg)
    segs = pipeline.segments(cfg)
    whole = rank = 0
    for name, p in model.named_parameters():
        b = p.numel() * 4
        whole += b
        block = pipeline.block_of(name)
        if block is not None and pipeline.stage_of(segs, pipe, block) \
                not in (None, 0):
            continue
        if tensor.expert_dim(name, p.shape, expert) is not None:
            b //= expert
        rank += b
    return whole, rank


def pp_launch_expect(steps, val_batches, test_batches, per_call, layers,
                     micro):
    """The kernels a rank's loop launches: ``layers`` pipelined layers of
    this rank run on each of ``micro`` microbatches a forward."""
    per = layers * micro
    return ({"trajectory_block": per * (steps + val_batches),
             "trajectory_block_bwd": per * steps,
             "trajectory_block_bwd_device": per * steps * per_call,
             "patch_embed": steps + val_batches},
            {"trajectory_block": per * test_batches,
             "patch_embed": test_batches})


def pp_yaml_run(per_call, problems):
    """(a): the pp_moe yaml as PP_RANKS gloo ranks on cuda:0 against the
    one-process pipelined model on the same batches, playing the PP_DATA
    data ranks too: its microbatches hold a mesh rank's rows (1 clip, where
    JAX's microbatch holds 2), so every GEMM has a rank's shape and the two
    differ in the order of the float32 reductions alone (with JAX's
    microbatches the weight gradients' bf16 partials differ by ~2.5e-3 and
    AdamW's first steps turn that into a 0.109 update apart: PERF.md PR
    26); the checkpoint the ranks write loaded in one process."""
    from focus_tpu_torch.engine.trainer import build_supervised_state
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.parallel import mesh, pipeline
    from focus_tpu_torch.utils import checkpoint as cu

    out_dir, spawn_s, ranks = pp_spawn("yaml", PP_RANKS)
    one_cfg = pp_cfg(os.path.join(PP_DIR, "one", "run"), ranks=1)
    (one,) = pp_spawn("one", 1)[2]
    r0 = ranks[0]
    a = [x for e in r0["losses"] for x in e]
    b = [x for e in one["losses"] for x in e]
    loss_rel = [abs(x - y) / abs(y) for x, y in zip(a, b)]
    aux_rel = [abs(x["moe_aux"] - y["moe_aux"]) / abs(y["moe_aux"])
               for x, y in zip(r0["stats"], one["stats"])]
    init = one["init"]
    init_same = all(torch.equal(r0["init"][k], v) for k, v in init.items())
    update = params_rel_l2({k: r0["params"][k] - init[k] for k in init},
                           {k: one["params"][k] - init[k] for k in init})
    by_param = sorted(
        ((float((r0["params"][k] - one["params"][k]).norm()
                / max(float((one["params"][k] - init[k]).norm()), 1e-30)), k)
         for k in init), reverse=True)[:6]
    ens = (r0["ensembles"] - one["ensembles"]).abs().max().item()
    apart = sorted({k for r in ranks[1:] for k, h in r["digest"].items()
                    if h != r0["digest"][k]})
    same_ranks = not apart
    same_aux = all(r["stats"] == r0["stats"] for r in ranks[1:])
    path = cu.get_last_checkpoint(os.path.join(out_dir, "run"))
    payload = cu.read_payload(path)
    with mesh.single_process_mesh():
        model = build_model(one_cfg, DEV)
        state = build_supervised_state(one_cfg, model, PP_STEPS)
    cu.restore_train_state(payload, state)
    loaded = (all(torch.equal(v.cpu(), payload["model_state"][k])
                  for k, v in model.state_dict().items())
              and all(torch.equal(payload["model_state"][k].float(), v)
                      for k, v in r0["params"].items()))
    opt = state.optimizer.state_dict()["state"]
    saved = payload["optimizer_state"]["state"]
    loaded = loaded and sorted(opt) == sorted(saved) and all(
        torch.equal(opt[i][k].cpu(), saved[i][k])
        for i in saved for k in saved[i] if torch.is_tensor(saved[i][k]))
    n_params = len(list(model.parameters()))
    del model, state, payload
    torch.cuda.empty_cache()
    whole, held = pp_bytes(one_cfg, 2, 2)
    bytes_ok = all(r["bytes"]["param_bytes"] == held and
                   2 * held <= r["bytes"]["optimizer_bytes"]
                   <= 2 * held + 4 * n_params for r in ranks)
    stages, micro = 2, pipeline.microbatches(one_cfg)
    layers = one_cfg.MF.DEPTH // stages
    val_batches = -(-PP_VAL // PP_BATCH)
    test_batches = -(-3 * PP_TEST_VIDEOS // PP_BATCH)
    want, test_want = pp_launch_expect(PP_STEPS, val_batches, test_batches,
                                       per_call, layers, micro)
    one_want, one_test_want = pp_launch_expect(
        PP_STEPS, val_batches, test_batches, per_call, 2 * layers,
        micro * PP_DATA)
    ok = (len(a) == len(b) == PP_STEPS and init_same
          and max(loss_rel) <= MESH_LOSS_REL and max(aux_rel) <= MESH_LOSS_REL
          and update <= MESH_UPDATE_REL and ens <= MESH_ENSEMBLE_ATOL
          and same_ranks and same_aux and loaded and bytes_ok
          and all(r["val_clips"] == PP_VAL for r in ranks)
          and all(r["test_counted"] == r["test_clips"] == 3 * PP_TEST_VIDEOS
                  for r in ranks)
          and all(launches_match(r["launches"], want)
                  and launches_match(r["test_launches"], test_want)
                  for r in ranks)
          and launches_match(one["launches"], one_want)
          and launches_match(one["test_launches"], one_test_want))
    if not ok:
        problems.append(
            f"pp_moe yaml: losses {a} vs {b}, moe_aux "
            f"{[s['moe_aux'] for s in r0['stats']]} vs "
            f"{[s['moe_aux'] for s in one['stats']]}, init equal {init_same}, "
            f"update {update:.3e} (largest by parameter {by_param}), "
            f"ensembles {ens:.3e}, ranks agree {same_ranks} {same_aux} "
            f"(apart: {apart[:12]}), checkpoint loads {loaded}, bytes "
            f"{[r['bytes'] for r in ranks]} (whole {whole}, a rank {held}), "
            f"val {[r['val_clips'] for r in ranks]}, test "
            f"{[(r['test_counted'], r['test_clips']) for r in ranks]}, "
            f"launches {[r['launches'] for r in ranks]} / {one['launches']} "
            f"(want {want} / {one_want})")
    step = [_mean_after_first(r["step_ms"]) for r in ranks]
    handoff = [_mean_after_first(r["handoff_ms"]) for r in ranks]
    expert = [_mean_after_first(r["expert_ms"]) for r in ranks]
    return {
        "backend": "gloo", "world": PP_RANKS, "device": "cuda:0 (all)",
        "mesh": "DATA 2 x PIPE 2 x EXPERT 2", "microbatches": micro,
        "one_process_plays_data_ranks": PP_DATA,
        "global_batch": PP_BATCH, "drop_path": one_cfg.MF.DROP_PATH,
        "losses_mesh": a, "losses_one_process": b,
        "moe_aux_mesh": [s["moe_aux"] for s in r0["stats"]],
        "moe_aux_one_process": [s["moe_aux"] for s in one["stats"]],
        "first_loss_rel_err": loss_rel[0], "max_loss_rel_err": max(loss_rel),
        "max_moe_aux_rel_err": max(aux_rel),
        "update_rel_l2": update, "update_rel_l2_largest_params": by_param,
        "ensembles_max_abs_err": ens,
        "ranks_bit_equal": same_ranks, "checkpoint_loads_bitwise": loaded,
        "val_clips_counted": [r["val_clips"] for r in ranks],
        "test_clips_counted": [r["test_counted"] for r in ranks],
        "whole_param_bytes": whole, "rank_param_bytes_expected": held,
        "rank_param_share": held / whole,
        "per_rank": [{
            "rank": r["rank"], "data_pipe_expert": r["coords"],
            "peak_memory_gb": r["peak_memory_gb"],
            "test_peak_memory_gb": r["test_peak_memory_gb"],
            "param_bytes": r["bytes"]["param_bytes"],
            "optimizer_bytes": r["bytes"]["optimizer_bytes"],
            "launches_train_loop": r["launches"],
            "launches_test": r["test_launches"],
            "step_ms": s, "handoff_ms": h, "expert_gather_ms": e,
            "handoff_share": h / s, "expert_gather_share": e / s}
            for r, s, h, e in zip(ranks, step, handoff, expert)],
        "one_process": {"peak_memory_gb": one["peak_memory_gb"],
                        "param_bytes": one["bytes"]["param_bytes"],
                        "optimizer_bytes": one["bytes"]["optimizer_bytes"],
                        "step_ms": _mean_after_first(one["step_ms"]),
                        "launches_train_loop": one["launches"]},
        "step_ms_mesh_rank0": step[0],
        "bubble_share": (stages - 1) / (micro + stages - 1),
        "timing_note": "step ms between CUDA events (after the first step); "
                       "the hand-offs' and expert gathers' host ms between "
                       "synchronisations of the card within each step; the "
                       "bubble share is the schedule's idle stage-ticks, "
                       "(PIPE - 1) / (M + PIPE - 1); gloo through the host "
                       "with 8 ranks on one card: no multi-card time",
        "spawn_and_run_seconds": spawn_s,
        "rule": f"first loss, losses and moe_aux within {MESH_LOSS_REL} "
                f"relative, update within {MESH_UPDATE_REL}, ensembles within "
                f"{MESH_ENSEMBLE_ATOL}, every val and test clip counted once "
                "on every rank, the checkpoint loads in one process bit for "
                "bit, a rank's parameter bytes its stage's blocks and half of "
                "their experts with every replicated leaf, the moments two "
                "of them and a step count a leaf, kernels 1 and 7 6 x 4 a "
                "step on a rank (12 x 8 in one process, which plays both "
                "data ranks' microbatches)"}


def pp_flagship_run(per_call, problems):
    """(b): the ORViT-MF flagship under PIPE 2 as two gloo ranks on cuda:0
    against the one-process pipelined model, PP_FLAGSHIP_STEPS steps."""
    from focus_tpu_torch.parallel import pipeline

    _, spawn_s, ranks = pp_spawn("flagship", 2)
    one_cfg = pp_flagship_cfg(1)
    one = pp_flagship_steps(one_cfg)
    segs = pipeline.segments(one_cfg)
    r0 = ranks[0]
    loss_rel = [abs(x - y) / abs(y) for x, y in zip(r0["losses"],
                                                    one["losses"])]
    init = one["init"]
    update = params_rel_l2({k: r0["params"][k] - init[k] for k in init},
                           {k: one["params"][k] - init[k] for k in init})
    init_same = all(torch.equal(r0["init"][k], v) for k, v in init.items())
    steps, micro = PP_FLAGSHIP_STEPS, pipeline.microbatches(one_cfg)
    piped = sum(b - a for a, b in segs)
    rest = one_cfg.MF.DEPTH - piped

    def expect(layers):
        per = rest + layers * micro
        return {"trajectory_block": per * steps,
                "trajectory_block_bwd": per * steps,
                "trajectory_block_bwd_device": per * steps * per_call,
                "patch_embed": steps}

    ok = (segs == [(2, 6)] and init_same and max(loss_rel) <= MESH_LOSS_REL
          and update <= MESH_UPDATE_REL
          and all(launches_match(r["launches"], expect(piped // 2))
                  for r in ranks)
          and launches_match(one["launches"], expect(piped)))
    if not ok:
        problems.append(
            f"flagship PIPE 2: segments {segs}, losses "
            f"{[r['losses'] for r in ranks]} vs {one['losses']}, init equal "
            f"{init_same}, update {update:.3e}, launches "
            f"{[r['launches'] for r in ranks]} / {one['launches']}")
    return {"ranks": 2, "mesh": "PIPE 2", "microbatches": micro,
            "batch": PP_BATCH, "segments": segs,
            "losses_mesh": r0["losses"], "losses_one_process": one["losses"],
            "first_loss_rel_err": loss_rel[0],
            "max_loss_rel_err": max(loss_rel), "update_rel_l2": update,
            "launches_per_rank": [r["launches"] for r in ranks],
            "launches_one_process": one["launches"],
            "peak_memory_gb_per_rank": [r["peak_memory_gb"] for r in ranks],
            "peak_memory_gb_one_process": one["peak_memory_gb"],
            "spawn_and_run_seconds": spawn_s,
            "rule": f"blocks 2-5 pipelined, losses within {MESH_LOSS_REL} "
                    f"relative, update within {MESH_UPDATE_REL}, kernels 1 "
                    "and 7 (8 replicated blocks + 2 stage blocks x 4 "
                    "microbatches) a step on a rank"}


def pp_eval_run(problems):
    """(c): the one-process pipelined pp_moe model (PIPE 2, 4
    microbatches) against the same weights at PIPE 1, eval at batch
    PP_BATCH."""
    from focus_tpu_torch.entry import example_inputs
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.parallel import mesh

    cfg = pp_cfg(os.path.join(PP_DIR, "eval"), ranks=1)
    plain = cfg.clone()
    plain.TPU.MESH.PIPE = plain.TPU.MESH.EXPERT = 1
    video, _ = example_inputs(cfg, PP_BATCH, 0, DEV)
    out = {}
    for name, c in (("pipelined", cfg), ("plain", plain)):
        with mesh.single_process_mesh():
            model = build_model(c, DEV, seed=0)
        with torch.no_grad():
            out[name] = counted(lambda: model(video).float().cpu())
        del model
        torch.cuda.empty_cache()
    err = (out["pipelined"][0] - out["plain"][0]).abs().max().item()
    depth = cfg.MF.DEPTH
    want = {"pipelined": {"trajectory_block": depth * cfg.TPU.MESH.
                          PIPE_MICROBATCHES, "patch_embed": 1},
            "plain": {"trajectory_block": depth, "patch_embed": 1}}
    ok = err <= PP_EVAL_ATOL and all(
        launches_match(out[k][1], want[k]) for k in want)
    if not ok:
        problems.append(f"eval pipelined vs plain: probabilities {err:.3e}, "
                        f"launches {out['pipelined'][1]} / {out['plain'][1]}")
    return {"batch": PP_BATCH, "probs_max_abs_err": err,
            "launches": {k: v[1] for k, v in out.items()},
            "peak_memory_gb": {k: v[2] for k, v in out.items()},
            "rule": f"probabilities within {PP_EVAL_ATOL}; 12 blocks x 4 "
                    "microbatches kernel-1 launches pipelined, 12 plain"}


def phase_pipe_expert(smi, per_call):
    """Phase 23: (a) the pp_moe yaml's mesh on the card, (b) the ORViT-MF
    flagship under PIPE 2, (c) the pipelined eval against the plain one.
    Returns the launches of (a) and (b) on rank 0."""
    from focus_tpu_torch.utils import logging as port_logging

    shutil.rmtree(PP_DIR, ignore_errors=True)
    os.makedirs(PP_DIR)
    problems = []
    result = {"phase": "pipe_expert", "gpu": smi}
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name], t0 = time.perf_counter() - t0, time.perf_counter()

    try:
        with open(PP_LOG, "w") as log, contextlib.redirect_stdout(log):
            result["yaml_mesh"] = pp_yaml_run(per_call, problems)
            lap("yaml_mesh")
            port_logging.close_logging()
            result["flagship_pipe2"] = pp_flagship_run(per_call, problems)
            lap("flagship_pipe2")
            result["eval_pipelined_vs_plain"] = pp_eval_run(problems)
            lap("eval")
    finally:
        result["seconds"] = seconds
        port_logging.close_logging()
        shutil.rmtree(PP_DIR, ignore_errors=True)
    result["ok"], result["problems"] = not problems, problems
    emit(result)
    if problems:
        raise AssertionError("pipe / expert phase failed")
    return {"yaml_rank0": result["yaml_mesh"]["per_rank"][0][
                "launches_train_loop"],
            "flagship_rank0": result["flagship_pipe2"]["launches_per_rank"][0]}


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
    loops = phase_train_engine(smi, bwd["device_launches_per_call"])
    for row, key in ((traj, "trajectory_block"), (patch, "patch_embed"),
                     (bwd, "trajectory_block_bwd")):
        row["launches_train_loop"] = sum(c[key] for c in loops)
        row["launches_note"] += (
            "; launches_train_loop over the train loop's two runs (phase 14: "
            f"HR-336 EK, {2 * HR_TRAIN_STEPS} steps at batch 16 and its "
            "validations; the flagship, "
            f"{2 * FLAGSHIP_TRAIN_STEPS} steps at batch "
            f"{FLAGSHIP_TRAIN_BATCH} in microbatches of "
            f"{FLAGSHIP_TRAIN_BATCH // FLAGSHIP_GRAD_ACCUM} and its "
            "validations)")
    bwd["device_launches_train_loop"] = sum(
        c["trajectory_block_bwd_device"] for c in loops)
    slot = phase_slot_train(smi)
    phase_conv_family(smi)
    phase_mvit(smi)
    phase_datasets(smi)
    moe = phase_moe(smi)
    phase_ava(smi)
    ddp = phase_ddp(smi, bwd["device_launches_per_call"])
    mesh_phase = phase_mesh(smi, bwd["device_launches_per_call"])
    pp_phase = phase_pipe_expert(smi, bwd["device_launches_per_call"])
    for row, key in ((traj, "trajectory_block"), (patch, "patch_embed"),
                     (bwd, "trajectory_block_bwd")):
        if key != "trajectory_block_bwd":
            row["launches_moe"] = moe["eval"][key]
        row["launches_moe_train"] = moe["train"][key]
        row["launches_note"] += (
            f"; launches_moe over {SLICE_ITERS} eval forwards of the "
            f"Switch-MoE Motionformer at batch {MOE_BATCH} (phase 19; 12 "
            "kernel-1 and 1 kernel-2 launches a forward), launches_moe_train "
            f"over {TRAIN_ITERS} of its train steps (12 kernel-1, 12 kernel-7 "
            "and 1 kernel-2 launches a step)")
    for row, key in ((traj, "trajectory_block"), (patch, "patch_embed"),
                     (bwd, "trajectory_block_bwd")):
        row["launches_ddp_nccl"] = ddp["nccl"][key]
        row["launches_ddp_gloo_rank0"] = ddp["gloo_rank0"][key]
        row["launches_note"] += (
            "; launches_ddp_nccl over phase 21's NCCL world-1 train loop "
            f"({DDP_STEPS} steps at batch {DDP_BATCH} under mixup, 12 "
            "kernel-1, 12 kernel-7 and 1 kernel-2 launches a step, and its "
            "2 val batches), launches_ddp_gloo_rank0 over rank 0's of the "
            f"two-rank loop on the one card ({DDP_STEPS} steps of 2 "
            "microbatches of 2 clips, and 2 val batches of 4)")
    for row, key in ((traj, "trajectory_block"), (patch, "patch_embed"),
                     (bwd, "trajectory_block_bwd")):
        row["launches_remat"] = mesh_phase["remat"].get(key, 0)
        row["launches_mesh_rank0"] = mesh_phase["mesh_rank0"][key]
        if key != "trajectory_block_bwd":
            row["launches_hr336_seq2_rank0"] = mesh_phase["hr_seq_rank0"][key]
        row["launches_note"] += (
            "; launches_remat in one flagship train step at batch "
            f"{REMAT_BATCH} under TPU.REMAT (phase 22 b: kernel 1 12 + 7 "
            "recomputed, kernel 7 12, kernel 2 1), launches_mesh_rank0 over "
            "rank 0's train loop of the dp x sp x tp yaml on the one card "
            f"(phase 22 c: {MESH_STEPS} steps of {MESH_ACCUM} microbatches "
            "and one validation, kernel 1 and 7 over its window of 4 query "
            "frames on all 12 heads), launches_hr336_seq2_rank0 in rank 0's "
            "HR-336 eval forward under SEQ 2 (phase 22 d)")
    for row, key in ((traj, "trajectory_block"), (patch, "patch_embed"),
                     (bwd, "trajectory_block_bwd")):
        row["launches_pp_moe_rank0"] = pp_phase["yaml_rank0"][key]
        row["launches_flagship_pipe2_rank0"] = pp_phase["flagship_rank0"][key]
        row["launches_note"] += (
            "; launches_pp_moe_rank0 over rank 0's train loop of the pp_moe "
            f"yaml on the one card (phase 23 a: {PP_STEPS} steps of 4 "
            "microbatches and one validation, kernels 1 and 7 on its stage's "
            "6 blocks a microbatch), launches_flagship_pipe2_rank0 over rank "
            f"0's {PP_FLAGSHIP_STEPS} flagship train steps under PIPE 2 "
            "(phase 23 b: 8 replicated blocks and 2 stage blocks x 4 "
            "microbatches a step)")
    windows = mesh_phase["windows"]
    traj["window"] = [{k: c[k] for k in (
        "case", "query_rows", "window_fwd_ms", "window_fwd_bound_ms",
        "window_fwd_bound_by", "timed_window_f0",
        "out_xs_q2_bitwise_equal_to_whole_rows")} for c in windows]
    bwd["window"] = [{k: c[k] for k in (
        "case", "query_rows", "window_bwd_ms", "window_bwd_bound_ms",
        "window_bwd_bound_by", "timed_window_f0",
        "dq_bitwise_equal_to_whole_rows")} for c in windows]
    ar["launches_slot_train"] = slot["wrapper"]
    ar["device_launches_slot_train"] = slot["device"]
    ar["launches_note"] += (
        "; launches_slot_train in phase 15: the MOVi-E STEVE trained through "
        f"tools.run_net, best_model.pt rolled out at 32 rows (D=192, 4 "
        f"blocks), {1 + STEVE_ITERS} rollouts of 256 steps, one graph "
        "capture (its one warm step counted) and a replay each")
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
