"""The host side of the redesigned forward kernels on the CPU: the launch
plans of kernel 1 (the fused trajectory core's forward,
``ops/trajectory_block.trajectory_core_plan``) and kernel 2 (the patch
embed, ``ops/patch_embed.patch_embed_plan``) held to their CUDA sources'
constants, the sources' structure (kernel 1's stage 1 on the wgmma / TMA
core it shares with kernel 8, kernel 2 on wgmma), the wrappers' refusals
before any build, and the plain stage-1 half that kernel 1 writes (xs, q2)
against the JAX package on the same numpy inputs."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu.ops import attention as jattn
from focus_tpu_torch.ops import patch_embed as tpe
from focus_tpu_torch.ops import trajectory_block as ttb

CSRC = os.path.join(os.path.dirname(ttb.__file__), "..", "csrc")
SMEM_LIMIT = 232_448


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constants(src, prefix):
    return dict(re.findall(rf"constexpr int ({prefix}\w+) = ([^;]+);", src))


# ---- kernel 1's plan -----------------------------------------------------------

@pytest.mark.parametrize("heads", [12, 16])
@pytest.mark.parametrize("N", [1, 65, 129, 196, 200, 256])
def test_trajectory_core_plan_fits_and_covers(N, heads):
    """Every launch fits the card's shared memory; stage 1's units and
    stage 2's row blocks cover every row and head; a stage-2 block holds
    every head, so a row block's xs is read once for the logits; the
    softmax weights fit in the chunk ring they reuse."""
    B, F = 2, 8
    S = F * N
    plan = ttb.trajectory_core_plan(B, S, F, N, heads)
    s1, s2 = plan["stage1"], plan["stage2"]
    assert s1["smem_bytes"] <= SMEM_LIMIT and s2["smem_bytes"] <= SMEM_LIMIT
    assert s1["units"] == B * heads * s1["query_tiles"]
    assert s1["query_tiles"] * s1["rows_per_tile"] >= S
    M = B * S
    assert plan["rows"] == M and plan["channels"] == 64 * heads
    assert s2["blocks"] * s2["rows_per_block"] >= M
    assert (s2["blocks"] - 1) * s2["rows_per_block"] < M
    assert s2["heads_per_block"] == heads and s2["g_warps"] == heads
    assert s2["g_warps"] <= s2["threads"] // 32
    assert s2["stages"] >= 2 and s2["g_buffers"] == 2
    assert s2["waves"] == -(-s2["blocks"] // 132)
    assert s2["xs_logit_reads_per_row_block"] == 1
    assert s2["chunks"] * s2["chunk_channels"] == 64 * heads
    assert s2["a2_bytes"] <= s2["ring_bytes"]
    gx, gy = plan["gemm"]["grid"]
    assert gx * 128 >= 64 * heads and gy * 128 >= M


def test_trajectory_core_plan_at_the_flagship_shapes():
    """At B = 8: stage 1 as kernel 8 at B x heads = 96 (208 keys, three
    K/V slots, a persistent grid of 132 blocks); stage 2 at N = 196 in 262
    blocks of 48 rows (two waves; 196 of 64 would take two as well) and at
    N = 200 in 200 blocks of 64 (267 of 48 would take three), 48 chunks of
    16 channels, three in flight."""
    plan = ttb.trajectory_core_plan(8, 1568, 8, 196, 12)
    assert plan["stage1"]["padded_keys"] == 208
    assert plan["stage1"]["stages"] == 3 and plan["stage1"]["grid"] == 132
    s2 = plan["stage2"]
    assert (s2["rows_per_block"], s2["blocks"], s2["waves"]) == (48, 262, 2)
    assert (s2["chunks"], s2["stages"], s2["smem_bytes"]) == (48, 3, 168_528)
    s2 = ttb.trajectory_core_plan(8, 1600, 8, 200, 12)["stage2"]
    assert (s2["rows_per_block"], s2["blocks"], s2["waves"]) == (64, 200, 2)
    assert s2["smem_bytes"] == 199_760 and s2["threads"] == 512
    assert ttb.trajectory_core_plan(8, 8 * 200, 8, 200, 16)["stage2"][
        "stages"] == 2


@pytest.mark.parametrize("N,heads,S", [(513, 12, 8 * 513), (196, 17, 8 * 196),
                                       (196, 12, 8 * 196 + 1)])
def test_trajectory_core_plan_refuses_what_the_kernel_does_not_take(N, heads,
                                                                    S):
    with pytest.raises(ValueError):
        ttb.trajectory_core_plan(1, S, 8, N, heads)


def test_trajectory_core_plan_matches_the_cuda_source():
    src = _source("trajectory_block.cu")
    const = _constants(src, "S2_")
    assert (const["S2_ROWS"], const["S2_MIN_ROWS"]) == tuple(
        str(r) for r in ttb.STAGE2_ROWS)
    assert const["S2_WARPS"] == "MAX_HEADS" and ttb.STAGE2_WARPS == 16
    assert const["S2_CH"] == str(ttb.STAGE2_CHANNELS)
    assert const["S2_MAX_STAGES"] == str(ttb.STAGE2_MAX_STAGES)
    assert const["S2_SMEM_LIMIT"] == str(ttb.SMEM_LIMIT)
    assert const["S2_LINE"] == "S2_CH + 8"
    assert const["S2_LINE_V3"] == "2 * S2_CH + 8"
    assert const["S2_WK_HEAD_BYTES"] == "S2_CH * HD * 2"
    assert const["S2_XS_ROW_BYTES"] == "MAX_F * S2_CH * 2"
    assert (const["S2_ALIGN"], const["S2_ZERO_BYTES"],
            const["S2_BAR_BYTES"]) == ("1024", "16", "64")
    assert "return heads * s2_line<V3>() + ((heads & 1) ? 0 : 8);" in src
    assert "return V3 ? S2_LINE_V3 : S2_LINE;" in src
    assert "return w48 * 48 < w64 * 64 ? S2_MIN_ROWS : S2_ROWS;" in src
    assert "S2_ALIGN + 2 * s2_g_bytes<V3>(heads, rows) + S2_ZERO_BYTES" in src
    core = _source("trajectory_core.cuh")
    assert "constexpr int GM = 128, GN = 128" in core
    assert ttb.GEMM_TILE == 128


@pytest.mark.parametrize("M,rows", [(12544, 48), (12800, 64), (1568, 48),
                                    (6272, 48), (8, 48), (25600, 48)])
def test_stage2_rows_fill_the_last_wave(M, rows):
    assert ttb.stage2_rows(M) == rows


# ---- kernel 2's plan -----------------------------------------------------------

PATCH_SHAPES = [((8, 16, 224, 224, 3), (2, 16, 16), 768),
                ((4, 16, 336, 336, 3), (2, 16, 16), 768),
                ((8, 15, 224, 224, 3), (2, 16, 16), 768),
                ((2, 16, 224, 224, 8), (2, 16, 16), 768)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kernel,D", PATCH_SHAPES)
def test_patch_embed_plan_fits_and_covers(shape, kernel, D, dtype):
    """Shared memory within the card's, a ring of at least three stages,
    the output staging inside the A stages it reuses, a grid that covers
    every patch row and output column, and 16-byte video copies at these
    crops (C = 3 and 8, kw = 16)."""
    plan = tpe.patch_embed_plan(shape, kernel, D, dtype)
    B, T, H, W, C = shape
    M = B * (T // kernel[0]) * (H // kernel[1]) * (W // kernel[2])
    assert plan["M"] == M and plan["K"] == kernel[0] * kernel[1] * kernel[2] * C
    assert plan["smem_bytes"] <= SMEM_LIMIT
    assert plan["stages"] >= 3
    assert plan["output_staging_bytes"] <= plan["stages"] * plan["a_stage_bytes"]
    gx, gy = plan["grid"]
    assert gx * plan["cols_per_block"] >= D and (gx - 1) * plan["cols_per_block"] < D
    assert gy * plan["rows_per_block"] >= M and (gy - 1) * plan["rows_per_block"] < M
    assert plan["copy_bytes"] == 16
    assert plan["k_steps"] * 64 >= plan["K"]


@pytest.mark.parametrize("shape,kernel,width", [
    ((1, 4, 37, 45, 1), (1, 4, 5), 1), ((1, 2, 16, 16, 2), (1, 2, 2), 4),
    ((1, 2, 15, 15, 3), (1, 3, 3), 1)])
def test_patch_embed_plan_narrows_the_copies_for_odd_runs(shape, kernel,
                                                          width):
    """Runs of kw * C values that 16 bytes do not divide take narrower
    copies through the same kernel (float32 video)."""
    plan = tpe.patch_embed_plan(shape, kernel, 36, torch.float32)
    assert plan["copy_elements"] == width
    assert plan["weight_row"] == 40  # D = 36 padded to a multiple of 8


def test_patch_embed_plan_matches_the_cuda_source():
    src = _source("patch_embed.cu")
    const = _constants(src, "PE_")
    assert const["PE_BM"] == str(tpe.BLOCK_ROWS)
    assert const["PE_BN"] == str(tpe.BLOCK_COLS)
    assert const["PE_BK"] == str(tpe.STAGE_K)
    assert const["PE_MAX_STAGES"] == str(tpe.MAX_STAGES)
    assert const["PE_SMEM_LIMIT"] == str(tpe.SMEM_LIMIT)
    assert const["PE_LDA"] == "PE_BK + 8"
    assert const["PE_TAIL_BYTES"] == "PE_BM * 8 + 256"
    assert const["PE_THREADS"] == "128 * (PE_WG + 1)" and const["PE_WG"] == "2"
    plan = tpe.patch_embed_plan((8, 16, 224, 224, 3), (2, 16, 16), 768)
    assert (plan["stages"], plan["smem_bytes"]) == (3, 211_200)


# ---- the sources' structure -----------------------------------------------------

def test_kernel_1_runs_stage_1_on_the_shared_wgmma_core():
    """Kernel 1 no longer launches the mma.sync stage 1; it and kernel 8
    include the shared stage-1 header, which holds the one persistent
    wgmma / TMA kernel; v5 and v6 now run their own-frame aggregates on it
    too, and trajectory_core.cuh keeps no mma.sync stage 1."""
    k1 = _source("trajectory_block.cu")
    assert "launch_stage1" not in k1
    assert '#include "space_stage_core.cuh"' in k1
    assert "launch_space_stage_keys<V3>(" in k1 and "launch_gemm(" in k1
    assert '#include "space_stage_core.cuh"' in _source("trajectory_attention.cu")
    core = _source("space_stage_core.cuh")
    assert "__global__ void __launch_bounds__(SS_THREADS, 1) space_stage_kernel(" in core
    assert "setmaxnreg" in core and "tma_store_4d" in core
    for variant in ("trajectory_block_v5.cu", "trajectory_block_v6.cu"):
        assert '#include "trajectory_k2v.cuh"' in _source(variant)
    assert '#include "space_stage_core.cuh"' in _source("trajectory_k2v.cuh")
    assert "launch_stage1" not in _source("trajectory_k2v.cuh")
    assert "launch_own_frame<NP, CH>(" in _source("trajectory_k2v.cuh")


def test_kernel_1_stage_2_holds_every_head_in_one_block():
    """Stage 2 is one kernel whose block owns all heads of its rows: one
    launch, no head-group grid dimension, the logits on mma.sync."""
    src = _source("trajectory_block.cu")
    assert len(re.findall(r"<<<", src)) == 1
    assert "traj_stage2_kernel<V3><<<(M + rows - 1) / rows, S2_THREADS" in src
    assert "constexpr int MAX_HPG" not in src and "head_groups(" not in src
    # g's two products, the logits' (and the mode V3's second, for lo)
    assert src.count("mma_16816(") == 4
    assert "tma_load_2d(" in src and "tma_load_3d(" in src
    assert "CU_TENSOR_MAP_SWIZZLE_32B" in src and "cp_async16" not in src


def test_kernel_2_is_a_wgmma_kernel():
    src = _source("patch_embed.cu")
    assert "nvcuda" not in src and "wmma::" not in src and "<mma.h>" not in src
    assert "wgmma_rs_n256_tb(" in src and "tma_load_2d(" in src
    assert "cp.async.mbarrier.arrive.noinc" in src
    assert len(re.findall(r"<<<", src)) == 1
    hdr = _source("hopper_async.cuh")
    assert "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16" in hdr
    assert "cp.async.bulk.tensor.2d" in hdr


# ---- the wrappers refuse before any build -----------------------------------------

def _no_build(*a, **k):
    raise AssertionError("built a kernel")


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("N,dtype,error", [(513, torch.bfloat16, ValueError),
                                           (196, torch.float32, TypeError)])
def test_trajectory_wrapper_refuses_before_any_build(monkeypatch, N, dtype,
                                                     error):
    monkeypatch.setattr(ttb, "_kernel_fn", _no_build)
    B, F, C = 1, 8, 768
    args = [_meta(B, F * N, C, dtype=dtype), _meta(B, F, N, C, dtype=dtype),
            _meta(B, F, N, C, dtype=dtype), _meta(C, C, dtype=dtype),
            _meta(C, dtype=dtype), _meta(C, C, dtype=dtype)]
    with pytest.raises(error):
        ttb._launch(*args, 0.125, 12)


@pytest.mark.parametrize("video_dtype,dtype", [(torch.float16, torch.bfloat16),
                                               (torch.float32, torch.float32)])
def test_patch_embed_wrapper_refuses_before_any_build(monkeypatch, video_dtype,
                                                      dtype):
    monkeypatch.setattr(tpe, "_kernel_fn", _no_build)
    x = _meta(1, 2, 16, 16, 3, dtype=video_dtype)
    with pytest.raises(TypeError):
        tpe._launch(x, _meta(2, 16, 16, 3, 8), _meta(8), (2, 16, 16), dtype)


# ---- the plain stage-1 half against the JAX package ---------------------------------

def test_stage1_reference_matches_jax():
    """xs and q2 (what kernel 1 writes for kernel 7) against the JAX
    package's space stage, diagonal and q2 on the same float32 inputs."""
    rs = np.random.RandomState(3)
    B, F, N, heads, hd = 2, 3, 12, 4, 4
    C, S = heads * hd, F * N
    q, kf, vf = ((rs.randn(*s) * 0.3).astype(np.float32)
                 for s in ((B, S, C), (B, F, N, C), (B, F, N, C)))
    wq2 = (rs.randn(C, C) * 0.2).astype(np.float32)
    bq2 = (rs.randn(C) * 0.1).astype(np.float32)
    scale = hd ** -0.5
    xs, q2 = ttb.trajectory_core_stage1_reference(
        *map(torch.from_numpy, (q, kf, vf, wq2, bq2)), scale, heads)

    def split(t):
        return jnp.asarray(t).reshape(B, -1, heads, hd).transpose(
            0, 2, 1, 3).reshape(B * heads, -1, hd)

    jxs = jattn.space_stage(split(q), split(kf.reshape(B, F * N, C)),
                            split(vf.reshape(B, F * N, C)), F, scale)
    jxs = jxs.reshape(B, heads, S, F, hd).transpose(0, 2, 3, 1, 4).reshape(
        B, S, F, C)
    jq2 = jattn.take_diagonal(jxs, F) @ wq2 + bq2
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), atol=2e-5)
    np.testing.assert_allclose(q2.numpy(), np.asarray(jq2), atol=2e-5)
