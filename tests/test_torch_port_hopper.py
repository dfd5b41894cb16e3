"""The host side of the port's Hopper-specific designs, on the CPU: the
space-stage kernel's launch plan (``ops/trajectory_attention.py``, kernel 8)
and the STEVE rollout graph (``ops/ar_decode.py``, kernel 9): the graph's
cache key and static buffers, the rollout's CPU path, which takes no graph,
and the CUDA sources' structure (every decode-step launch through the PDL
helper, every decode-step kernel waiting on the one before it, kernel 8 on
wgmma and TMA rather than the fused core's stage 1)."""

import os
import re

import numpy as np
import pytest
import torch

from focus_tpu_torch.entry import steve_entry
from focus_tpu_torch.ops import ar_decode as tar
from focus_tpu_torch.ops import trajectory_attention as tta

CSRC = os.path.join(os.path.dirname(tta.__file__), "..", "csrc")


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


# ---- kernel 8's plan -----------------------------------------------------------

@pytest.mark.parametrize("N", [196, 200, 256, 1, 64, 65, 129])
def test_space_stage_plan_fits_and_covers(N):
    """Shared memory within the card's 232,448 bytes with at least two frame
    slots, the keys padded to a wgmma width that holds N, and query tiles
    that cover S; the grid is the SM count or the units, whichever is
    smaller."""
    F, BH = 8, 96
    S = F * N
    plan = tta.space_stage_plan(BH, S, F, N)
    assert plan["smem_bytes"] <= 232_448
    assert plan["stages"] >= 2
    assert plan["padded_keys"] >= N and plan["padded_keys"] % 16 == 0
    assert plan["padded_keys"] <= 256
    tiles = plan["query_tiles"]
    assert tiles * plan["rows_per_tile"] >= S
    assert (tiles - 1) * plan["rows_per_tile"] < S
    assert plan["units"] == BH * tiles
    assert plan["grid"] == min(plan["units"], 132)


def test_space_stage_plan_at_the_learned_v_shapes():
    """At N = 196 and 200 the keys pad to 208 (one m64n208 wgmma), three
    K/V slots fit, and the 13 query tiles of each of the 96 rows fill a
    persistent grid of 132 blocks."""
    for N in (196, 200):
        plan = tta.space_stage_plan(96, 8 * N, 8, N)
        assert plan["padded_keys"] == 208
        assert plan["stages"] == 3
        assert plan["smem_bytes"] == 227_328
        assert plan["query_tiles"] == 13 and plan["grid"] == 132
        assert plan["threads"] == 384


@pytest.mark.parametrize("N", [513, 1024, 0])
def test_space_stage_plan_refuses_what_the_kernel_does_not_take(N):
    with pytest.raises(ValueError, match="N <= 512"):
        tta.space_stage_plan(4, 8 * max(N, 1), 8, N)


def _space_stage_source():
    """Kernel 8's source and the stage-1 header its kernel lives in (shared
    with the fused core's forward)."""
    return _source("trajectory_attention.cu") + _source("space_stage_core.cuh")


def test_space_stage_plan_matches_the_cuda_source():
    """The plan's constants are the kernel's."""
    src = _space_stage_source()
    const = dict(re.findall(r"constexpr int (SS_\w+) = ([^;]+);", src))
    assert const["SS_SMEM_LIMIT"] == str(tta.SMEM_LIMIT)
    assert const["SS_MAX_NP"] == str(tta.MAX_KEYS)
    assert const["SS_HD"] == str(tta.HEAD_DIM)
    assert const["SS_WG"] == "2" and const["SS_MAX_STAGES"] == "4"
    assert const["SS_ROWS"] == "64 * SS_WG"
    assert "n <= 64 ? 64 : (n <= 128 ? 128 : (n <= 208 ? 208 : 256))" in src


def test_space_stage_kernel_is_its_own_hopper_kernel():
    """Kernel 8 runs both products on wgmma, fills its frame slots by TMA
    completed on mbarriers, and no longer launches the fused core's stage
    1; trajectory_core.cuh keeps no mma.sync stage 1 (kernels 5 and 6 run
    their own-frame aggregates on the same wgmma kernel since their
    redesign)."""
    src = _space_stage_source()
    assert "launch_stage1" not in src and "trajectory_core.cuh" not in src
    assert "wgmma_ss<NP>" in src and "wgmma_rs_n64_tb" in src
    assert "tma_load_3d" in src and "mbar_wait" in src
    assert "tma_store_4d" in src
    assert len(re.findall(r"<<<", src)) == 1  # one launch a call
    hdr = _source("hopper_async.cuh")
    assert "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16" in hdr
    assert "cp.async.bulk.tensor.3d" in hdr
    assert "launch_stage1" not in _source("trajectory_core.cuh")
    assert "traj_stage1_kernel" not in _source("trajectory_core.cuh")


def test_space_stage_wrapper_refuses_257_keys_before_any_build(monkeypatch):
    """On a CUDA tensor the wrapper checks the plan before it builds or
    launches anything (meta tensors stand in for the card's here): 257 and
    512 keys a frame pass the check (the chunked form) and reach the
    build, 513 raises before it."""
    def no_build(*a, **k):
        raise AssertionError("built a kernel")

    monkeypatch.setattr(tta, "_kernel_fn", no_build)
    for N in (257, 512):
        q = torch.empty(2, 8 * N, 64, dtype=torch.bfloat16, device="meta")
        kf = torch.empty(2, 8, N, 64, dtype=torch.bfloat16, device="meta")
        with pytest.raises(AssertionError, match="built a kernel"):
            tta._launch(q, kf, kf, 0.125)
    q = torch.empty(2, 8 * 513, 64, dtype=torch.bfloat16, device="meta")
    kf = torch.empty(2, 8, 513, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="N <= 512"):
        tta._launch(q, kf, kf, 0.125)


# ---- kernel 9's launches ----------------------------------------------------------

def _kernel_bodies(src):
    """name -> body text of every __global__ function of a source."""
    bodies = {}
    for m in re.finditer(r"__global__ void[^{]*?(\w+_kernel)\(", src):
        start = src.index("{", m.end())
        depth, i = 0, start
        while True:
            depth += {"{": 1, "}": -1}.get(src[i], 0)
            if depth == 0:
                break
            i += 1
        bodies[m.group(1)] = src[start:i]
    return bodies


def test_every_decode_step_launch_goes_through_the_pdl_helper():
    src = _source("ar_decode.cu")
    assert "<<<" not in src
    assert src.count("cudaLaunchKernelEx(&cfg") == 1
    assert "cudaLaunchAttributeProgrammaticStreamSerialization" in src
    assert src.count("++step_launches") == 1
    launches = re.findall(r"return (?:\(int\))?launch_pdl\(", src)
    assert len(launches) == 6  # quantize, layernorm, 2 GEMMs, attention, argmax


@pytest.mark.parametrize("kernel", [
    "quantize_rows_kernel", "layernorm_kernel", "skinny_gemm_kernel",
    "skinny_gemm_s8_kernel", "attention_kernel", "argmax_gather_kernel"])
def test_every_decode_step_kernel_waits_before_it_writes(kernel):
    """griddepcontrol.wait comes before the trigger and before any store:
    what precedes it only prefetches."""
    body = _kernel_bodies(_source("ar_decode.cu"))[kernel]
    wait = body.index("pdl_wait()")
    assert wait < body.index("pdl_trigger()")
    before = body[:wait]
    assert not re.search(r"\[[^\]]*\]\s*[+\-*]?=(?!=)", before), before
    assert "gemm_store" not in before and "->" not in before


def test_launches_per_step_unchanged():
    assert tar.launches_per_step(8) == 91
    assert tar.launches_per_step(8, w8a8=True) == 115


# ---- the rollout graph ------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_steve():
    fn, _ = steve_entry(device="cpu", batch=1, frames=2, tiny=True)
    return fn.model


def test_rollout_graph_key_tells_shapes_and_modes_apart():
    key = tar.rollout_graph_key(32, False, 256, torch.bfloat16, False)
    assert key == tar.rollout_graph_key(32, 0, 256, torch.bfloat16, 0)
    others = [tar.rollout_graph_key(128, False, 256, torch.bfloat16, False),
              tar.rollout_graph_key(32, True, 256, torch.bfloat16, False),
              tar.rollout_graph_key(32, False, 16, torch.bfloat16, False),
              tar.rollout_graph_key(32, False, 256, torch.float32, False),
              tar.rollout_graph_key(32, False, 256, torch.bfloat16, True)]
    assert len({key, *others}) == 6
    hash(key)


@pytest.mark.parametrize("w8a8,with_logits", [
    (False, False), (False, True), (True, False), (True, True)])
def test_rollout_buffers_shapes(tiny_steve, w8a8, with_logits):
    model = tiny_steve
    packed = model._packed_decoder(torch.bfloat16, w8a8=w8a8)
    nb = model.steve_decoder.tf.num_blocks
    d, V, S = model.d_model, model.vocab_size, model.num_slots
    gen, rows = (model.image_size // 4) ** 2, 5
    bufs = tar.rollout_buffers(packed, rows, d, S, gen, with_logits)
    bf = torch.bfloat16
    assert bufs == {
        "x": ((2, rows, d), bf),
        "k_cache": ((nb, gen + 1, rows, d), bf),
        "v_cache": ((nb, gen + 1, rows, d), bf),
        "ckv": ((nb, 2, rows, S, d), bf),
        "pos": ((gen + 1, d), torch.float32),
        "ids": ((gen, rows), torch.int32),
        "logits": ((gen if with_logits else 1, rows, V), torch.float32),
    }


def test_rollout_graph_runs_on_cuda_only(tiny_steve):
    packed = tiny_steve._packed_decoder(torch.bfloat16)
    before = tar.GRAPH_CAPTURES
    with pytest.raises(ValueError, match="CUDA"):
        tar.RolloutGraph(packed, 2, 1, tiny_steve.d_model, 3, 16, "cpu")
    assert tar.GRAPH_CAPTURES == before


@pytest.mark.parametrize("int8", [False, True])
def test_cpu_rollout_takes_the_plain_per_step_path(tiny_steve, monkeypatch,
                                                   int8):
    """On the CPU the fused rollout takes the plain step once a token and
    never a graph, with ``rollout_graphs`` left on; its ids are those of
    the step-by-step plain version and of the module rollout (bf16)."""
    model = tiny_steve
    assert model.rollout_graphs

    def no_graph(*a, **k):
        raise AssertionError("a rollout graph on the CPU")

    calls = []
    step = tar.fused_ar_step

    def counting_step(*a, **k):
        calls.append(a[1])
        return step(*a, **k)

    monkeypatch.setattr(tar, "RolloutGraph", no_graph)
    monkeypatch.setattr(tar, "fused_ar_step", counting_step)
    monkeypatch.setattr(model, "int8_serving", int8)
    rs = np.random.RandomState(3)
    slots = torch.from_numpy(rs.randn(2, 3, 192).astype(np.float32))
    gen = (model.image_size // 4) ** 2
    lg = torch.empty(gen, 2, model.vocab_size)
    ids = model.decode_ids(slots, logits=lg)
    assert calls == list(range(gen))
    assert model._rollout_graphs == {}
    model.rollout_graphs = False
    try:
        assert torch.equal(model.decode_ids(slots), ids)
    finally:
        model.rollout_graphs = True
    if not int8:
        model.fused_ar_step = False
        try:
            assert torch.equal(model.decode_ids(slots), ids)
        finally:
            model.fused_ar_step = True
    assert torch.isfinite(lg).all()


def test_free_rollout_graphs_empties_the_cache(tiny_steve):
    model = tiny_steve
    model._rollout_graphs["sentinel"] = object()
    model.free_rollout_graphs()
    assert model._rollout_graphs == {}
