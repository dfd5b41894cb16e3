"""Where the time of a slice's main path goes, on one GPU.

    python3 -m focus_tpu_torch.profile_slice \
        [--model flagship|steve|train|learned_v|hr336|hr336_train] \
        [--batch 8] \
        [--iters 2] \
        [--trace trace.json] [--int8] [--fast-gelu] [--fwd-version 3|4|5|6|7]
        [--hr]

Builds ``entry(device="cuda")`` (the flagship eval forward),
``train_entry(device="cuda")`` (one flagship train step: forward, backward
and the AdamW update), ``hr_entry(device="cuda")`` (the HR-336
EPIC-Kitchens eval forward; ``--batch`` defaults to 4 there, as the JAX
companion's), ``hr_train_entry(device="cuda")`` (``hr336_train``: one
HR-336 train step, batch 4) or ``steve_entry(device="cuda")`` (STEVE's encode +
KV-cached rollout + dVAE decode; ``--batch`` videos of 4 frames), warms up,
then traces ``--iters`` calls with ``torch.profiler`` (CPU and CUDA
activities). Prints one JSON
line: the wall time per call, the summed device time of the device-side
events (kernels and device copies), the time the device was busy with at
least one of them (kernels launched with programmatic dependent launch
overlap, so the sum can exceed it) and its share of the wall time, the
events with the most device time, and the events that add the most to the
busy time (``top_exposed``: from the later of an event's start and the end
of every event before it, to its own end), and the peak device memory
allocated over the traced calls. STEVE's rollout is one replay of its
captured CUDA graph (made in the warm-up). ``--trace`` also writes the
Chrome trace to the path given. The labeled serving variants:
``--int8`` (``TPU.INT8_SERVING``: W8A8 dense layers in the flagship, the
W8A8 decode step in STEVE) and ``--fast-gelu`` (``TPU.FAST_GELU``, the
flagship only). ``--fwd-version`` sets the trajectory core's
``FWD_VERSION`` (flagship, train, hr336 and hr336_train). ``--model
learned_v`` is the eval forward of ``profile_block.learned_v_stack``: 12
learned-v trajectory blocks (``use_original_code=False``) at D=768, 12
heads, 8 x 14 x 14 tokens plus CLS; with ``--hr`` at the 336 crop's 8 x 21
x 21 (N = 441 keys a frame, kernel 8's chunked form).
"""

import argparse
import json
import re
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from focus_tpu_torch.entry import (
    entry,
    hr_entry,
    hr_train_entry,
    steve_entry,
    train_entry,
)
from focus_tpu_torch.ops import trajectory_block
from focus_tpu_torch.profile_block import learned_v_stack


# device kernels of the port's hand-written kernels, by the start of their
# names (a regular expression; a kernel counts in the first group it
# matches): kernel 1's three stages apart (its stage 1 is the space stage's
# kernel, which kernel 8 launches in the learned-v model, or at N > 256 its
# chunked form, which kernels 3, 4 and 8 run there too), and kernels 3
# and 4's (FWD_VERSION 3 and 7: the same kernels in the rounding mode V3,
# template argument true; the GEMM is one kernel for all versions), kernels
# 5 and 6's own-frame launch and pass (FWD_VERSION 6 and 5; the pass's
# second template argument is true for v5, its third 2 in the chunked form
# at N > 256, as the own-frame launch's second), kernel 2, and kernel 7's
# eight kernels one by one (its dq kernel at N > 256 in its chunked form)
_TRUE = r"(?:true|\(bool\)1)"
_FALSE = r"(?:false|\(bool\)0)"
KERNEL_GROUPS = (
    (rf"space_stage_kernel<\d+, {_TRUE}>", "kernels 3 / 4 stage 1 (mode V3)"),
    (rf"traj_stage2_kernel<{_TRUE}>", "kernels 3 / 4 stage 2 (mode V3)"),
    ("space_stage_kernel", "kernel 1 stage 1 (flagship) / kernel 8 (learned_v)"),
    ("space_stage_chunked_kernel",
     "stage 1, chunked (N > 256, HR-336): kernels 1, 3, 4 and 8"),
    (r"own_frame_kernel<\d+, 2>", "kernels 5 / 6 own-frame x_diag, chunked"),
    ("own_frame_kernel", "kernels 5 / 6 own-frame x_diag"),
    (rf"k2v_pass_kernel<\d+, {_TRUE}, 2>", "kernel 6 pass (v5), chunked"),
    (rf"k2v_pass_kernel<\d+, {_FALSE}, 2>", "kernel 5 pass (v6), chunked"),
    (rf"k2v_pass_kernel<\d+, {_TRUE}, 1>", "kernel 6 pass (v5)"),
    (rf"k2v_pass_kernel<\d+, {_FALSE}, 1>", "kernel 5 pass (v6)"),
    ("traj_gemm_kernel",
     "kernel 1 / 3 / 4 q2 GEMM, kernels 5 / 6 k2v and q2 GEMMs"),
    ("traj_stage2_kernel", "kernel 1 stage 2"),
    ("patch_embed_kernel", "kernel 2 (patch embed)"),
    ("stage2_rows_kernel", "kernel 7 stage-2 rows"),
    ("stage2_dwk2_kernel", "kernel 7 stage-2 dWk2"),
    ("stage2_dxs_kernel", "kernel 7 stage-2 dxs"),
    ("gemm_kernel", "kernel 7 dd and dWq2 GEMMs"),
    ("sum_splits_kernel", "kernel 7 sums"),
    ("stage1_dq_kernel", "kernel 7 stage-1 dq"),
    ("stage1_dq_chunked_kernel", "kernel 7 stage-1 dq, chunked (N > 256)"),
    ("stage1_dkdv_kernel", "kernel 7 stage-1 dk/dv"),
)


def kernel_groups(rows, iters):
    """{group: device ms and launches per call} of the rows whose names
    start with a KERNEL_GROUPS prefix (template arguments follow it)."""
    groups = {}
    for name, count, us in rows:
        for prefix, label in KERNEL_GROUPS:
            if re.search(rf"(?:^|::|\s){prefix}[<(]", name):
                g = groups.setdefault(label, {"device_ms_per_call": 0.0,
                                              "launches_per_call": 0.0})
                g["device_ms_per_call"] += us / 1e3 / iters
                g["launches_per_call"] += count / iters
                break
    return groups


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _busy_us(prof):
    """Length of the union of the device-side events' intervals (us), and
    each event name's exposed share of it: the time from the later of its
    start and every earlier event's end to its own end, which is what it
    adds to the device's busy time when kernels overlap."""
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
        and e.time_range.end > e.time_range.start)
    total, end, exposed = 0.0, float("-inf"), {}
    for a, b, name in spans:
        if b > end:
            total += b - max(a, end)
            exposed[name] = exposed.get(name, 0.0) + b - max(a, end)
            end = b
    return total, exposed


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model",
                    choices=("flagship", "steve", "train", "learned_v",
                             "hr336", "hr336_train"),
                    default="flagship")
    ap.add_argument("--batch", type=int, default=None,
                    help="8 (hr336, hr336_train, learned_v --hr: 4)")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--trace", default=None, help="Chrome trace output path")
    ap.add_argument("--int8", action="store_true",
                    help="TPU.INT8_SERVING (flagship or steve)")
    ap.add_argument("--fast-gelu", action="store_true",
                    help="TPU.FAST_GELU (flagship)")
    ap.add_argument("--fwd-version", type=int, choices=trajectory_block.PORTED_FWD_VERSIONS,
                    default=4,
                    help="the trajectory core's FWD_VERSION (flagship, train, "
                         "hr336, hr336_train)")
    ap.add_argument("--hr", action="store_true",
                    help="learned_v at the 336 crop (8 x 21 x 21 patches)")
    args = ap.parse_args()

    variant = {}
    if args.int8:
        variant["int8"] = True
    if args.fast_gelu:
        variant["fast_gelu"] = True
    if args.model in ("train", "learned_v", "hr336", "hr336_train") and variant or (
            args.model == "steve" and args.fast_gelu):
        ap.error(f"--model {args.model} takes no {sorted(variant)}")
    if args.fwd_version != 4 and args.model not in (
            "flagship", "train", "hr336", "hr336_train"):
        ap.error(f"--model {args.model} takes no --fwd-version")
    if args.hr and args.model != "learned_v":
        ap.error(f"--model {args.model} takes no --hr")
    trajectory_block.FWD_VERSION = args.fwd_version
    if args.batch is None:
        args.batch = 4 if args.model.startswith("hr336") or args.hr else 8
    if args.model == "learned_v":
        model, x = learned_v_stack(device="cuda", batch=args.batch,
                                   hr=args.hr)

        @torch.no_grad()
        def fn(x):
            return model(x)

        inputs = (x,)
    else:
        make = {"flagship": entry, "steve": steve_entry,
                "train": train_entry, "hr336": hr_entry,
                "hr336_train": hr_train_entry}[args.model]
        fn, inputs = make(device="cuda", batch=args.batch, **variant)
    for _ in range(2):
        fn(*inputs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn(*inputs)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.iters
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # device-side events only: a CPU op's device time repeats its kernels',
    # and so does a user annotation's span on the device (the optimizer's)
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    rows = [r for r in rows if r[2] > 0]
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows) / 1e3 / args.iters
    busy_us, exposed = _busy_us(prof)
    busy_ms = busy_us / 1e3 / args.iters
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({
        "profile": {"flagship": "flagship eval forward",
                    "steve": "STEVE reconstruct_autoregressive",
                    "train": "flagship train step",
                    "learned_v": "12 learned-v trajectory blocks, eval",
                    "hr336": "HR-336 EPIC-Kitchens eval forward",
                    "hr336_train": "HR-336 EPIC-Kitchens train step"}[
                        args.model],
        "variant": variant, "fwd_version": args.fwd_version, "hr": args.hr,
        "batch": args.batch,
        "gpu": smi, "wall_ms_per_call": wall_ms,
        "device_ms_per_call": device_ms if rows else "not measured",
        "device_busy_ms_per_call": busy_ms if rows else "not measured",
        "device_busy_share": busy_ms / wall_ms if rows else "not measured",
        "peak_memory_gb": peak_gb,
        "kernel_groups": kernel_groups(rows, args.iters),
        "top_kernels": [
            {"name": k[:120], "launches_per_call": c / args.iters,
             "device_ms_per_call": us / 1e3 / args.iters}
            for k, c, us in rows[: args.top]
        ],
        "top_exposed": [
            {"name": k[:120], "exposed_device_ms_per_call": us / 1e3 / args.iters}
            for k, us in sorted(exposed.items(), key=lambda kv: -kv[1])[: args.top]
        ],
    }), flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
