"""Hold this tree's kernels against another commit's build of them, on one
GPU, in one process.

    git archive <commit> focus_tpu_torch/csrc | tar -x -C proof/parent
    python3 -m focus_tpu_torch.compare_parent \
        --parent proof/parent/focus_tpu_torch/csrc

Compiles the other commit's sources (with this tree's nvcc flags, into
``build/parent/``) and calls both builds through this tree's wrappers on
the same inputs:

  - bit-equality: kernel 8 (``space_stage_bf16``, the space stage at the
    learned-v shapes and at N = 65 and 256), kernel 1 (``traj_core_bf16``:
    out, xs and q2) and kernels 3, 4, 5 and 6 (``traj_core_v3_bf16``,
    ``traj_core_v7_bf16``, ``traj_core_v5_bf16``, ``traj_core_v6_bf16``:
    out and the xs, q2 and scratch each writes) at B = 8, N = 196 and 200,
    on an extreme input, and at B = 2, N = 65 and 256 (the narrowest and
    widest key widths at N <= 256); ``torch.equal`` on every output, and
    beside it the largest difference of the two builds' outputs over the
    other's largest value. Kernel 1 also at B = 2, N = 441 and 512 (its
    chunked stage 1, which the other build has too where it takes such N).
    Kernels 3 to 6 and 8 are compared at N <= 256 alone: a build from
    before their chunked forms refuses more keys a frame;
  - kernel 7 (``traj_core_bwd_bf16``, the backward) bit for bit on all six
    gradients at B = 8, N = 196 and 200, B = 2, N = 232 (its dq kernel's
    NP = 256 form) and an extreme input, from the xs and q2 of this tree's
    kernel 1 on the same inputs; and at B = 8, N = 196 the other build,
    this one, this one, the other in turns (the median of 20 per-call
    times); and at B = 2, N = 441 and 512 (its chunked dq kernel);
  - kernel 1 (``traj_core_bf16``) at B = 8, N = 196 and 200: the other
    build, this one, this one, the other, each the median of 20 per-call
    CUDA-event times, and each build's output against the plain version;
  - kernels 3, 4, 5 and 6 (``traj_core_v3_bf16``, ``traj_core_v7_bf16``,
    ``traj_core_v5_bf16``, ``traj_core_v6_bf16``, each from whichever of
    the other build's sources defines it) at B = 8, N = 196 and 200: the
    other build, this one and kernel 1 of this one on the same inputs, in
    turns (the median of 20 per-call times, and the median
    of 5 rounds of 20 calls back to back), each against its plain
    version;
  - kernel 2 (``patch_embed_bf16``) on the flagship's video
    [8, 16, 224, 224, 3]: the other build, this one and ``F.conv3d`` (on a
    contiguous NCTHW copy and on the channels_last_3d view of the same bf16
    video) called in turns, 20 rounds after warm-up, the medians; and both
    builds on the float32 video.

Prints one JSON line per comparison and the card's nvidia-smi line; exits
non-zero if a bit-equality fails or no CUDA device is present.
"""

import argparse
import ctypes
import functools
import json
import os
import statistics
import subprocess
import sys

import torch

from focus_tpu_torch.ops import _build
from focus_tpu_torch.ops import patch_embed as pe
from focus_tpu_torch.ops import trajectory_attention as ta
from focus_tpu_torch.ops import trajectory_block as tb

SYMBOLS = {  # kernel -> (symbol, n_ptr, n_int, n_float)
    "space_stage": ("space_stage_bf16", 4, 5, 1),
    "v4": ("traj_core_bf16", 9, 6, 1),
    "v3": ("traj_core_v3_bf16", 10, 6, 1),
    "v7": ("traj_core_v7_bf16", 10, 6, 1),
    "v5": ("traj_core_v5_bf16", 11, 6, 1),
    "v6": ("traj_core_v6_bf16", 11, 6, 1),
    "patch_embed": ("patch_embed_bf16", 4, 10, 0),
    "bwd": ("traj_core_bwd_bf16", 25, 6, 1),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def source_of(csrc, symbol):
    """The other commit's ``.cu`` file (its name, no suffix) that defines
    ``symbol``."""
    for name in sorted(os.listdir(csrc)):
        if name.endswith(".cu"):
            with open(os.path.join(csrc, name)) as f:
                if f'extern "C" int {symbol}(' in f.read():
                    return name[:-3]
    raise RuntimeError(f"no source in {csrc} defines {symbol}")


def build_parent(csrc):
    """Compile the other commit's sources that define SYMBOLS, in parallel
    -> {kernel: bound C function}."""
    sources = {kernel: source_of(csrc, entry[0])
               for kernel, entry in SYMBOLS.items()}
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "parent")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in set(sources.values()):
        lib = os.path.join(out_dir, f"lib{name}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib,
               os.path.join(csrc, f"{name}.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the other {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    fns = {}
    for kernel, (symbol, n_ptr, n_int, n_float) in SYMBOLS.items():
        fn = getattr(libs[sources[kernel]], symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[kernel] = fn
    return fns


class use:
    """Within the block, ``module.<attr>`` returns ``fn`` (the other
    build's bound function) instead of this tree's."""

    def __init__(self, module, attr, fn):
        self.module, self.attr, self.fn = module, attr, fn

    def __enter__(self):
        self.saved = getattr(self.module, self.attr)
        setattr(self.module, self.attr, self.fn)

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.saved)


def time_turns(fns, warmup=3, iters=20):
    """Median per-call CUDA-event time (ms) of each callable, the callables
    called in turns, one call of each a round."""
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


def core_inputs(B, N, gen, F=8, C=768):
    def rnd(*shape, sc=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * sc).bfloat16()

    return [rnd(B, F * N, C), rnd(B, F, N, C), rnd(B, F, N, C),
            rnd(C, C, sc=3 * C ** -0.5), rnd(C, sc=0.1),
            rnd(C, C, sc=3 * C ** -0.5)]


def extreme_inputs(gen, sign=-1.0, mag=60.0, B=1, F=8, N=196, C=768,
                   heads=12):
    """Stage-1 logits of ~sign * mag nats after the scale
    (tests/test_fused_block.py:_extreme_inputs at the kernels' widths)."""
    scale = (C // heads) ** -0.5
    qdir = torch.randn(B, F * N, C, generator=gen, device="cuda")
    qdir = qdir / qdir.norm(dim=-1, keepdim=True)
    amp = (mag / scale) ** 0.5
    kf = (qdir.reshape(B, F, N, C)[:, :1, :1].expand(B, F, N, C) * amp
          + torch.randn(B, F, N, C, generator=gen, device="cuda") * 0.01)
    rest = [torch.randn(*shape, generator=gen, device="cuda") * sc
            for shape, sc in (((B, F, N, C), 0.2), ((C, C), 0.1), ((C,), 0.1),
                              ((C, C), 0.1))]
    return [t.bfloat16().contiguous()
            for t in [qdir * amp * sign, kf] + rest]


def time_turns_back_to_back(fns, rounds=5, iters=20):
    """Per-call time (ms) of each callable as the mean of ``iters`` calls
    issued back to back between two events; the callables take turns, one
    run of ``iters`` each a round; the median over ``rounds`` rounds."""
    for fn in fns:
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(rounds):
        for i, fn in enumerate(fns):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end) / iters)
    return [statistics.median(t) for t in times]


def max_rel(out, ref):
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def forward_version(parent, v):
    """(the module attribute that binds forward version ``v``, its launch,
    the binder to put there for the other build) for 3, 7, 5 and 6."""
    if v in (3, 7):
        return (f"_v{v}_kernel_fn", getattr(tb, f"_launch_v{v}"),
                lambda: parent[f"v{v}"])
    return ("_variant_kernel_fn", functools.partial(tb._launch_variant, v),
            lambda version: parent[f"v{version}"])


def outputs(result):
    """{name: tensor} of what a forward launch wrote: out, xs, q2 and the
    scratch of v5 and v6."""
    named = dict(zip(("out", "xs", "q2"), result[:3]))
    if len(result) > 3:
        named.update(result[3])
    return {k: t for k, t in named.items() if t is not None}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the other commit's focus_tpu_torch/csrc directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        emit({"ok": False, "error": "CUDA is not available"})
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    parent = build_parent(args.parent)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    scale, heads, failures = 64 ** -0.5, 12, []

    # kernel 8, bit for bit
    for N in (196, 200, 65, 256):
        S = 8 * N
        q, k, v = (torch.randn(96, S, 64, generator=gen, device="cuda")
                   .bfloat16() for _ in range(3))
        kf, vf = k.reshape(96, 8, N, 64), v.reshape(96, 8, N, 64)
        mine = ta._launch(q, kf, vf, scale)
        with use(ta, "_kernel_fn", lambda: parent["space_stage"]):
            theirs = ta._launch(q, kf, vf, scale)
        torch.cuda.synchronize()
        same = torch.equal(mine, theirs)
        failures += [] if same else [f"space_stage N={N}"]
        emit({"compare": "space_stage", "N": N, "bitwise_equal": same})

    # kernel 1 (its stage 1 and GEMM share code with the mode V3 and with
    # v5 and v6), kernels 3, 4, 5 and 6, bit for bit
    inputs = [("B=8 N=196", core_inputs(8, 196, gen)),
              ("B=8 N=200", core_inputs(8, 200, gen)),
              ("extreme -60", extreme_inputs(gen)),
              ("B=2 N=65", core_inputs(2, 65, gen)),
              ("B=2 N=256", core_inputs(2, 256, gen)),
              ("B=2 N=441", core_inputs(2, 441, gen)),
              ("B=2 N=512", core_inputs(2, 512, gen))]
    for tag, a in inputs:
        mine = tb._launch(*a, scale, heads)
        with use(tb, "_kernel_fn", lambda: parent["v4"]):
            theirs = tb._launch(*a, scale, heads)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(mine, theirs))
        failures += [] if same else [f"v4 {tag}"]
        emit({"compare": "trajectory_block", "case": tag,
              "outputs": ["out", "xs", "q2"], "bitwise_equal": same})
        del mine, theirs
        if a[1].shape[2] > tb.MAX_KEYS:
            continue  # kernels 3 to 6: no parent past 256 keys a frame
        for version in (3, 7, 5, 6):
            attr, launch, other = forward_version(parent, version)
            mine = outputs(launch(*a, scale, heads))
            with use(tb, attr, other):
                theirs = outputs(launch(*a, scale, heads))
            torch.cuda.synchronize()
            same = {k: torch.equal(mine[k], theirs[k]) for k in mine}
            failures += [] if all(same.values()) else [f"v{version} {tag}"]
            emit({"compare": f"trajectory_block_v{version}", "case": tag,
                  "bitwise_equal": same,
                  "max_diff_rel_to_other": {k: max_rel(mine[k], theirs[k])
                                            for k in mine}})
            del mine, theirs
    del inputs
    torch.cuda.empty_cache()

    # kernel 7, bit for bit on the six gradients, then in turns at N = 196
    def backward(a, dout, xs, q2, other=False):
        if other:
            with use(tb, "_bwd_kernel_fn", lambda: parent["bwd"]):
                return tb._launch_backward(*a, dout, xs, q2, scale, heads)
        return tb._launch_backward(*a, dout, xs, q2, scale, heads)

    for tag, a in (("B=8 N=196", core_inputs(8, 196, gen)),
                   ("B=8 N=200", core_inputs(8, 200, gen)),
                   ("B=2 N=232", core_inputs(2, 232, gen)),
                   ("extreme -60", extreme_inputs(gen)),
                   ("B=2 N=441", core_inputs(2, 441, gen)),
                   ("B=2 N=512", core_inputs(2, 512, gen))):
        dout = (torch.randn(a[0].shape, generator=gen, device="cuda")
                * 0.1).bfloat16()
        _, xs, q2 = tb._launch(*a, scale, heads)
        mine = backward(a, dout, xs, q2)
        theirs = backward(a, dout, xs, q2, other=True)
        torch.cuda.synchronize()
        names = ("dq", "dkf", "dvf", "dwq2", "dbq2", "dwk2")
        same = {n: torch.equal(x, y) for n, x, y in zip(names, mine, theirs)}
        failures += [] if all(same.values()) else [f"bwd {tag}"]
        row = {"compare": "trajectory_block_bwd", "case": tag,
               "bitwise_equal": same,
               "max_diff_rel_to_other": {
                   n: max_rel(x, y) for n, x, y in zip(names, mine, theirs)}}
        if tag == "B=8 N=196":
            t = time_turns([lambda: backward(a, dout, xs, q2, other=True),
                            lambda: backward(a, dout, xs, q2),
                            lambda: backward(a, dout, xs, q2),
                            lambda: backward(a, dout, xs, q2, other=True)])
            row.update(other_ms=[t[0], t[3]], this_ms=[t[1], t[2]])
        emit(row)
        del a, dout, xs, q2, mine, theirs
        torch.cuda.empty_cache()

    # kernel 1: the other build and this one in turns
    for N in (196, 200):
        a = core_inputs(8, N, gen)
        ref = tb.trajectory_core_reference(*[t.float() for t in a], None,
                                           scale, heads)
        out = tb._launch(*a, scale, heads)[0]
        with use(tb, "_kernel_fn", lambda: parent["v4"]):
            out_p = tb._launch(*a, scale, heads)[0]

        def theirs():
            with use(tb, "_kernel_fn", lambda: parent["v4"]):
                tb._launch(*a, scale, heads)

        def mine():
            tb._launch(*a, scale, heads)

        t_p1, t_c1, t_c2, t_p2 = time_turns([theirs, mine, mine, theirs])
        emit({"compare": "trajectory_block", "B": 8, "N": N,
              "other_ms": [t_p1, t_p2], "this_ms": [t_c1, t_c2],
              "this_max_err_rel": max_rel(out, ref),
              "other_max_err_rel": max_rel(out_p, ref)})

    # kernels 3, 4, 5 and 6: the other build, this one and kernel 1 in
    # turns
    plain = {3: tb.trajectory_core_v3_reference,
             7: tb.trajectory_core_v7_reference,
             5: tb.trajectory_core_v5_reference,
             6: tb.trajectory_core_v6_reference}
    for N in (196, 200):
        a = core_inputs(8, N, gen)
        for v in (3, 7, 5, 6):
            ref = plain[v](*a, None, scale, heads)
            attr, launch, other = forward_version(parent, v)
            out = launch(*a, scale, heads)[0]
            with use(tb, attr, other):
                out_p = launch(*a, scale, heads)[0]

            def theirs():
                with use(tb, attr, other):
                    launch(*a, scale, heads)

            def mine():
                launch(*a, scale, heads)

            def kernel_1():
                tb._launch(*a, scale, heads)

            turns = [theirs, mine, kernel_1, mine, theirs]
            per_call = time_turns(turns)
            b2b = time_turns_back_to_back(turns)
            emit({"compare": f"trajectory_block_v{v}", "B": 8, "N": N,
                  "other_ms": [per_call[0], per_call[4]],
                  "this_ms": [per_call[1], per_call[3]],
                  "kernel_1_ms": per_call[2],
                  "other_ms_back_to_back": [b2b[0], b2b[4]],
                  "this_ms_back_to_back": [b2b[1], b2b[3]],
                  "kernel_1_ms_back_to_back": b2b[2],
                  "this_max_err_rel": max_rel(out, ref),
                  "other_max_err_rel": max_rel(out_p, ref),
                  "plain": f"{plain[v].__name__} on the same bf16 inputs"})
            del ref
        del a
        torch.cuda.empty_cache()

    # kernel 2 and F.conv3d in turns on the same bf16 video
    kernel, D = (2, 16, 16), 768
    x32 = torch.rand(8, 16, 224, 224, 3, generator=gen, device="cuda")
    x16 = x32.bfloat16()
    w = (torch.randn(2, 16, 16, 3, D, generator=gen, device="cuda")
         * 0.02).bfloat16()
    b = (torch.randn(D, generator=gen, device="cuda") * 0.02).bfloat16()
    w_conv = w.permute(4, 3, 0, 1, 2).contiguous()
    w_conv_cl = w_conv.contiguous(memory_format=torch.channels_last_3d)
    x_ncthw = x16.permute(0, 4, 1, 2, 3).contiguous()
    x_cl = x16.permute(0, 4, 1, 2, 3)
    conv = torch.nn.functional.conv3d
    ref = pe.patch_embed_reference(x16.float(), w.float(), b.float(), kernel)

    def run(x, other):
        if other:
            with use(pe, "_kernel_fn", lambda: parent["patch_embed"]):
                return pe._launch(x, w, b, kernel, torch.bfloat16)
        return pe._launch(x, w, b, kernel, torch.bfloat16)

    errs = {f"{who}_{x.dtype}": max_rel(run(x, who == "other"), ref)
            for who in ("other", "this") for x in (x16, x32)}
    t = time_turns([lambda: run(x16, True), lambda: run(x16, False),
                    lambda: conv(x_ncthw, w_conv, b, stride=kernel),
                    lambda: conv(x_cl, w_conv_cl, b, stride=kernel)])
    t32 = time_turns([lambda: run(x32, True), lambda: run(x32, False),
                      lambda: run(x32, False), lambda: run(x32, True)])
    emit({"compare": "patch_embed", "video": [8, 16, 224, 224, 3],
          "bf16_in_turns_ms": {"other": t[0], "this": t[1],
                               "conv3d_ncthw_copy": t[2],
                               "conv3d_channels_last_view": t[3]},
          "f32_ms": {"other": [t32[0], t32[3]], "this": [t32[1], t32[2]]},
          "max_err_rel": errs})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"ok": not failures, "failures": failures, "gpu": smi})
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
