"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Run from the repository root:  python3 chip_smoke.py

Phases (one JSON line each; any failure exits non-zero):
  1. environment and build: the card's name and power limit, TF32 off for
     every comparison, the CUDA kernels built from focus_tpu_torch/csrc/;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the flagship forward gives it, plus extreme stage-1 logits;
     kernel, plain and (where one exists) library times by CUDA events;
  3. the port's layers against the golden fixture of the reference
     ORViT-MF (plain path, float32, on the card);
  4. the flagship slice: ORViT-Motionformer SSv2 16x224 (D=768, 12 layers,
     12 heads, ORViT at [1, 6, 10], bf16) at batch 8 through the kernels,
     with launch counts, throughput, peak memory, and the probabilities held
     against the same model and weights on the plain path.
Then the kernel table, the card's nvidia-smi line, and the result line.
The script imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
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


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
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
    dev = "cuda"

    def rnd(*shape, sc=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * sc).bfloat16()

    return [rnd(B, S, C), rnd(B, F, N, C), rnd(B, F, N, C),
            rnd(C, C, sc=3 * C ** -0.5), rnd(C, sc=0.1),
            rnd(C, C, sc=3 * C ** -0.5), rnd(C, sc=0.1)]


def extreme_inputs(sign, mag, gen, B=1, F=8, N=196, C=768, heads=12):
    """tests/test_fused_block.py:_extreme_inputs at the kernel's widths:
    stage-1 logits of ~sign*mag nats after the scale."""
    S, dev = F * N, "cuda"
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


def check_close(name, out, ref, rel=KERNEL_TOL_REL):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    ok = bool(torch.isfinite(out).all()) and err <= rel * scale
    if not ok:
        raise AssertionError(f"{name}: max|err| {err:.3e} > {rel} x max|ref| "
                             f"{scale:.3e} (or non-finite output)")
    return err, scale


def phase_trajectory_kernel():
    from focus_tpu_torch.ops import trajectory_block as tb

    heads, scale = 12, 64 ** -0.5
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases, errs = [], []
    timing = None
    for B, N in ((2, 196), (2, 200), (8, 196), (8, 200)):
        args = core_inputs(B, N, gen)
        out = tb.fused_trajectory_core(*args, scale, heads)
        ref = tb.trajectory_core_reference(*[a.float() for a in args],
                                           scale, heads)
        torch.cuda.synchronize()
        err, ref_max = check_close(f"trajectory_block B={B} N={N}", out, ref)
        errs.append(err)
        case = {"B": B, "S": 8 * N, "N": N, "max_abs_err": err,
                "max_abs_ref": ref_max}
        if B == 8:
            S, C = 8 * N, 768
            case["kernel_ms"] = time_ms(
                lambda: tb.fused_trajectory_core(*args, scale, heads))
            case["plain_ms"] = time_ms(
                lambda: tb.trajectory_core_reference(*args, scale, heads),
                warmup=1, iters=TIMED_ITERS)
            case["bound_ms"], case["bound_by"] = bound(
                core_flops(B, S, 8, N, C), nbytes(*args) + nbytes(out))
            case["xs_scratch_bytes"] = B * S * 8 * C * 2
            if N == 196:
                timing = case
        del args, out, ref
        cases.append(case)
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
                      "max_abs_ref": ref_max})
    emit({"phase": "kernel", "name": "trajectory_block", "ok": True,
          "tolerance": f"max|err| <= {KERNEL_TOL_REL} x max|ref| (bf16 "
                       "intermediates vs plain float32 on the same inputs)",
          "library_ms": None,
          "library_note": "no single PyTorch call computes trajectory attention",
          "cases": cases})
    return {"name": "trajectory_block", "route": "cuda",
            "source": "focus_tpu_torch/csrc/trajectory_block.cu",
            "replaces": "focus_tpu/ops/pallas/trajectory_block.py:246",
            "max_abs_err": max(errs), "ms": timing["kernel_ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"], "library_ms": None,
            "shape": "B=8 S=1568 N=196 F=8 C=768 heads=12"}


def phase_patch_kernel():
    from focus_tpu_torch.ops import patch_embed as pe

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    kernel, D = (2, 16, 16), 768
    x32 = torch.rand(8, 16, 224, 224, 3, generator=gen, device="cuda")
    x16 = x32.bfloat16()
    w = (torch.randn(2, 16, 16, 3, D, generator=gen, device="cuda") * 0.02).bfloat16()
    b = (torch.randn(D, generator=gen, device="cuda") * 0.02).bfloat16()
    ref = pe.patch_embed_reference(x16.float(), w.float(), b.float(), kernel)
    errs = []
    for x in (x16, x32):  # bf16 video, and the float32 video the model hands it
        out, thw = pe.patch_embed_3d(x, w, b, kernel, torch.bfloat16)
        torch.cuda.synchronize()
        assert tuple(out.shape) == (8, 1568, D) and thw == (8, 14, 14)
        errs.append(check_close(f"patch_embed {x.dtype}", out, ref)[0])
    kernel_ms = time_ms(lambda: pe.patch_embed_3d(x32, w, b, kernel, torch.bfloat16))
    plain_ms = time_ms(lambda: pe.patch_embed_reference(x32, w, b, kernel,
                                                         torch.bfloat16))
    x_ncthw = x16.permute(0, 4, 1, 2, 3).contiguous()
    w_conv = w.permute(4, 3, 0, 1, 2).contiguous()
    library_ms = time_ms(
        lambda: torch.nn.functional.conv3d(x_ncthw, w_conv, b, stride=kernel))
    M, K = 8 * 1568, 2 * 16 * 16 * 3
    bound_ms, bound_by = bound(2 * M * K * D,
                               nbytes(x32, w, b) + M * D * 2)
    emit({"phase": "kernel", "name": "patch_embed", "ok": True,
          "tolerance": f"max|err| <= {KERNEL_TOL_REL} x max|ref| (bf16 output "
                       "vs plain float32 on the same bf16 inputs)",
          "max_abs_err_bf16_video": errs[0], "max_abs_err_f32_video": errs[1],
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "library_ms": library_ms,
          "library_call": "F.conv3d, bf16, NCTHW input permuted beforehand",
          "bound_ms": bound_ms, "bound_by": bound_by})
    return {"name": "patch_embed", "route": "cuda",
            "source": "focus_tpu_torch/csrc/patch_embed.cu",
            "replaces": "focus_tpu/ops/pallas/patch_embed.py:33",
            "max_abs_err": max(errs), "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "shape": "video [8,16,224,224,3] f32 -> [8,1568,768] bf16"}


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
    model = build_model(cfg, device="cuda")
    model.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in d.items()
                           if k.startswith("sd/")}, strict=True)
    model.use_kernels = False  # head dim 12: the kernels take 64
    video = torch.from_numpy(d["video"].transpose(0, 2, 3, 4, 1).copy()).cuda()
    with torch.no_grad():
        out = model(video, {"orvit_bboxes": torch.from_numpy(d["boxes"]).cuda()})
    err = (out.cpu() - torch.from_numpy(d["out"])).abs().max().item()
    if not err <= FIXTURE_ATOL:
        raise AssertionError(f"fixture orvit_mf_full: max|err| {err:.3e}")
    emit({"phase": "fixture", "name": "orvit_mf_full", "ok": True,
          "max_abs_err": err, "atol": FIXTURE_ATOL})


def phase_slice(smi):
    from focus_tpu_torch.entry import entry
    from focus_tpu_torch.ops import patch_embed as pe
    from focus_tpu_torch.ops import trajectory_block as tb

    B = 8
    fn, (video, boxes) = entry(device="cuda", batch=B, seed=0)
    model = fn.model
    for _ in range(2):
        fn(video, boxes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tb.LAUNCHES = pe.LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(SLICE_ITERS):
        probs = fn(video, boxes)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"trajectory_block": tb.LAUNCHES, "patch_embed": pe.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect = {"trajectory_block": 12 * SLICE_ITERS, "patch_embed": SLICE_ITERS}
    if launches != expect:
        raise AssertionError(f"launch counts {launches}, expected {expect}")

    model.use_kernels = False
    plain = fn(video, boxes)
    model.use_kernels = True
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(probs).all() and torch.isfinite(plain).all())
    max_abs = (probs - plain).abs().max().item()
    top1 = (probs.argmax(-1) == plain.argmax(-1)).float().mean().item()
    sums = probs.sum(-1)
    ok = (tuple(probs.shape) == (B, 174) and finite
          and max_abs <= SLICE_PROB_ATOL and top1 >= SLICE_TOP1_MIN_SHARE
          and bool(((sums - 1).abs() < 1e-3).all()))
    result = {"phase": "slice", "ok": ok,
              "model": "ORViT-MF SSv2 16x224, D=768, 12 layers, 12 heads, "
                       "ORViT at [1,6,10], O=4, bf16, exact-erf GELU",
              "batch": B, "timed_batches": SLICE_ITERS,
              "clips_per_sec": B * SLICE_ITERS / seconds,
              "ms_per_batch": 1e3 * seconds / SLICE_ITERS,
              "peak_memory_gb": peak_gb, "launches": launches,
              "launches_per_forward": {k: v / SLICE_ITERS
                                       for k, v in launches.items()},
              "vs_plain_path": {"max_abs_prob": max_abs,
                                "atol": SLICE_PROB_ATOL,
                                "top1_agreement": top1,
                                "top1_min_share": SLICE_TOP1_MIN_SHARE},
              "finite": finite, "gpu": smi}
    emit(result)
    if not ok:
        raise AssertionError("slice check failed")
    return launches


def main():
    if not torch.cuda.is_available():
        emit({"ok": False, "error": "CUDA is not available"})
        return 1
    try:
        import focus_tpu_torch  # noqa: F401
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
    kernels = [phase_trajectory_kernel(), phase_patch_kernel()]
    phase_fixture()
    launches = phase_slice(smi)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_note"] = f"over {SLICE_ITERS} flagship forwards"
    emit({"kernels": kernels})
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
