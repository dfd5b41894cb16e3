"""Kernels 3 and 4 (the trajectory core's forward versions 3 and 7) on the
CPU, as the card runs them since their redesign: kernel 1's three launches
in the rounding mode V3 (``csrc/trajectory_block.cu``). The kernel's plain
mirror (``ops/trajectory_block.trajectory_core_v3_mirror``: unnormalised
bf16 stage-1 weights with float32 sums, the GEMM's scaled stage-2 query,
g kept in float32 as a bf16 hi + lo pair, float32 stage-2 weights) against
the v3 / v7 plain version, the JAX package's interpret-mode v3 and v7
kernels and the extreme stage-1 logits; the launch plan in the mode V3
held to the CUDA source's constants; and the sources' structure."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu.ops.pallas import trajectory_block as jtb
from focus_tpu_torch.ops import trajectory_block as ttb

from tests.test_torch_port_kernels import core_inputs, extreme_inputs

CSRC = os.path.join(os.path.dirname(ttb.__file__), "..", "csrc")
SMEM_LIMIT = 232_448
HEADS, C = 2, 128  # head dim 64, as the kernel takes it
TOL_REL = 2e-2  # the card's KERNEL_TOL_REL, as the variants test uses it
# the card's bound on kernels 3 and 4's xs, mean|err| / mean|ref| against
# the plain stage 1 in v3 rounding (chip_smoke.py V3_XS_MEAN_REL)
XS_MEAN_REL = 6e-5


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _bf16(args):
    return [torch.from_numpy(a).bfloat16() for a in args]


def _close(out, ref, rel=TOL_REL):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(out).all()
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, (err, scale)


# ---- the mirror ----------------------------------------------------------------

@pytest.mark.parametrize("B,F,N", [(2, 3, 12), (1, 4, 24), (2, 2, 8)])
def test_mirror_matches_the_v3_plain_version(B, F, N):
    """The kernel's arithmetic against the v3 / v7 plain version on the same
    bf16 inputs: out within 2e-2 x max|ref|; xs and q2 against the plain
    stage-1 half in v3 rounding as the card holds them."""
    args = _bf16(core_inputs(B=B, F=F, N=N, C=C, seed=B * 10 + N))
    scale = 64 ** -0.5
    inter = {}
    out = ttb.trajectory_core_v3_mirror(*args, scale, HEADS,
                                        intermediates=inter)
    assert out.dtype == torch.bfloat16 and out.shape == (B, F * N, C)
    _close(out.float(), ttb.trajectory_core_v3_reference(*args, scale, HEADS)
           .float())
    xs, q2 = ttb.trajectory_core_v3_stage1_reference(*args[:5], scale, HEADS)
    _close(inter["xs"].float(), xs.float())
    _close(inter["q2"].float(), q2.float())
    # the stage-2 query is the scaled q2 rounded from float32
    _close(inter["qs"], q2.float() * scale)


def _mean_rel(out, ref):
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().mean() / ref.abs().mean()).item()


@pytest.mark.parametrize("sign,mag", [(None, None), (-1.0, 60.0),
                                      (1.0, 50.0)])
def test_v3_stage1_reference_tells_the_roundings_apart(sign, mag):
    """What the card's check of kernels 3 and 4's xs rests on: on the same
    bf16 operands the mirror's xs (p rounded before it is normalised) reads
    within XS_MEAN_REL of trajectory_core_v3_stage1_reference, and kernel
    1's rounding (trajectory_core_stage1_reference: p normalised, then
    rounded) reads above it, though both pass the max|err| gate."""
    if sign is None:
        args = _bf16(core_inputs(B=1, F=4, N=24, C=C, seed=11))
        scale = 64 ** -0.5
    else:
        raw, scale = extreme_inputs(sign, mag, F=4, N=24, C=C, heads=HEADS)
        args = _bf16(raw)
    inter = {}
    ttb.trajectory_core_v3_mirror(*args, scale, HEADS, intermediates=inter)
    xs_ref, _ = ttb.trajectory_core_v3_stage1_reference(*args[:5], scale,
                                                        HEADS)
    xs_v4, _ = ttb.trajectory_core_stage1_reference(*args[:5], scale, HEADS)
    _close(inter["xs"].float(), xs_ref.float())
    _close(xs_v4.float(), xs_ref.float())
    assert _mean_rel(inter["xs"], xs_ref) <= XS_MEAN_REL < _mean_rel(xs_v4,
                                                                   xs_ref)


@pytest.mark.parametrize("version", [3, 7])
def test_mirror_matches_pallas_interpret(version):
    """Against the JAX package's v3 (under its KERNEL_FLAGS) and v7 kernels
    in interpret mode on the same bf16 inputs (within 2e-2 x max|ref|: the
    TPU kernels clamp exp2 with no max where the card takes a true max)."""
    args = core_inputs(B=1, F=2, N=8, C=C, seed=5)
    scale = 64 ** -0.5
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in args]
    pallas = {3: jtb._fused_fwd_pallas, 7: jtb._fused_fwd_pallas_v7}[version]
    ref = np.asarray(pallas(*jargs, scale, HEADS, interpret=True)
                     .astype(jnp.float32))
    out = ttb.trajectory_core_v3_mirror(*_bf16(args), scale, HEADS)
    _close(out.float().numpy(), ref)


@pytest.mark.parametrize("sign,mag", [(-1.0, 60.0), (1.0, 50.0)])
def test_mirror_extreme_logits(sign, mag):
    """Peaked stage-1 logits (tests/test_fused_block.py:_extreme_inputs at
    the kernel's head dim): the true per-frame max keeps the unnormalised
    weights in (0, 1], and the mirror stays within 2e-2 x max|ref| of the
    v3 plain version and of the XLA composition in float32."""
    args, scale = extreme_inputs(sign, mag, F=2, N=12, C=C, heads=HEADS)
    out = ttb.trajectory_core_v3_mirror(*_bf16(args), scale, HEADS)
    _close(out.float(), ttb.trajectory_core_v3_reference(
        *_bf16(args), scale, HEADS).float())
    xla = jtb._xla_reference(*map(jnp.asarray, args), scale, HEADS)
    _close(out.float().numpy(), np.asarray(xla))


def test_split_g_logits_need_the_lo_part():
    """The stage-2 logits from g's hi + lo pair are within 2^-15 of the
    float32-g logits, relative to sum_c |g_c xs_c| (the split leaves at most
    2^-16 |g| of g out); from g rounded to bf16 alone they miss that bound,
    which is why the kernel keeps the lo part."""
    args = _bf16(core_inputs(B=2, F=3, N=12, C=C, seed=9))
    inter = {}
    ttb.trajectory_core_v3_mirror(*args, 64 ** -0.5, HEADS,
                                  intermediates=inter)
    g, hi, lo = inter["g"], inter["g_hi"], inter["g_lo"]
    xs = inter["xs"].float()
    assert ((g - hi - lo).abs() <= 2.0 ** -16 * g.abs()).all()
    assert ((g - hi).abs() > 2.0 ** -16 * g.abs()).any()
    exact = torch.einsum("bshc,bsfc->bshf", g.double(), xs.double())
    size = torch.einsum("bshc,bsfc->bshf", g.abs().double(),
                        xs.abs().double())
    split_err = (inter["logits"].double() - exact).abs() / size
    assert split_err.max() <= 2.0 ** -15
    bf16_err = (torch.einsum("bshc,bsfc->bshf", hi.double(), xs.double())
                - exact).abs() / size
    assert bf16_err.max() > 2.0 ** -15


def test_mirror_in_float32_is_the_trajectory_core():
    """Where nothing is rounded (float32 operands), the mirror computes the
    trajectory core's function: within 2e-5 of the plain core."""
    args = [torch.from_numpy(a) for a in core_inputs(B=1, F=3, N=12, C=C,
                                                      seed=4)]
    scale = 64 ** -0.5
    np.testing.assert_allclose(
        ttb.trajectory_core_v3_mirror(*args, scale, HEADS).numpy(),
        ttb.trajectory_core_reference(*args, scale, HEADS).numpy(),
        atol=2e-5)


# ---- the plan in the mode V3 -------------------------------------------------------

@pytest.mark.parametrize("heads", [2, 4, 12, 14, 16])
@pytest.mark.parametrize("N", [1, 65, 196, 200, 256])
def test_v3_plan_fits_and_covers(N, heads):
    """Every launch fits the card's shared memory; stage 2's blocks cover
    every row with every head, keep at least two ring slots with the hi +
    lo g buffers, and the float32 stage-2 weights fit in the ring they
    reuse."""
    B, F = 8, 8
    S = F * N
    plan = ttb.trajectory_core_plan(B, S, F, N, heads, v3=True)
    s1, s2 = plan["stage1"], plan["stage2"]
    assert plan["rounding"] == "v3" and plan["device_launches"] == 3
    assert plan["gemm"]["outputs"] == 2
    assert s1["smem_bytes"] <= SMEM_LIMIT and s2["smem_bytes"] <= SMEM_LIMIT
    M = B * S
    assert s2["blocks"] * s2["rows_per_block"] >= M
    assert (s2["blocks"] - 1) * s2["rows_per_block"] < M
    assert s2["heads_per_block"] == heads and s2["g_parts"] == 2
    assert s2["g_line"] == 40 and s2["logit_mma_per_row_chunk"] == 2
    assert s2["stages"] >= 2 and s2["a2_bytes"] <= s2["ring_bytes"]
    assert s2["rows_per_block"] in (48, 64)


def test_v3_plan_at_the_flagship_shapes():
    """At B = 8, 12 heads: 48-row blocks with three ring slots at N = 196
    (two waves), 64-row blocks with two at N = 200 (48 would take a third
    wave); at 16 heads 48 rows, since 64 would leave one slot."""
    s2 = ttb.trajectory_core_plan(8, 1568, 8, 196, 12, v3=True)["stage2"]
    assert (s2["rows_per_block"], s2["blocks"], s2["waves"]) == (48, 262, 2)
    assert (s2["stages"], s2["smem_bytes"]) == (3, 205_392)
    s2 = ttb.trajectory_core_plan(8, 1600, 8, 200, 12, v3=True)["stage2"]
    assert (s2["rows_per_block"], s2["blocks"], s2["waves"]) == (64, 200, 2)
    assert (s2["stages"], s2["smem_bytes"]) == (2, 207_952)
    assert ttb.stage2_rows(8 * 1600, heads=16, v3=True) == 48
    assert ttb.stage2_rows(8 * 1600, heads=16) == 64
    # kernel 1's plan is what it was
    assert ttb.trajectory_core_plan(8, 1600, 8, 200, 12)["stage2"][
        "smem_bytes"] == 199_760


def test_v3_plan_matches_the_cuda_source():
    src = _source("trajectory_block.cu")
    const = dict(re.findall(r"constexpr int (S2_\w+) = ([^;]+);", src))
    assert const["S2_LINE_V3"] == "2 * S2_CH + 8"
    assert ttb._stage2_bytes(12, 64, True)[0] == 2 * ttb.STAGE2_CHANNELS + 8
    assert "return V3 ? S2_LINE_V3 : S2_LINE;" in src
    assert ("return s2_stages<true>(heads, S2_ROWS) < 2 ? S2_MIN_ROWS : "
            "s2_rows(M, sms);") in src
    assert "const int rows = V3 ? s2_rows_v3(M, sms, heads) : " \
           "s2_rows(M, sms);" in src
    # the GEMM writes the scaled query into out, stage 2 reads it there
    # with the logit scale 1, and a2 stays float32
    assert "S, F, N, C, st, V3 ? out_ : nullptr, scale);" in src
    assert "V3 ? out_ : static_cast<const bf16*>(q2)" in src
    assert "V3 ? 1.0f : scale" in src
    assert "a2[f0] = V3 ? e0 / sum : round_bf16(e0 / sum);" in src
    core = _source("trajectory_core.cuh")
    assert "__floats2bfloat162_rn(v0 * scale, v1 * scale);" in core


# ---- the sources ---------------------------------------------------------------------

def test_v3_and_v7_run_stage_1_on_the_shared_wgmma_core():
    """Both entries are kernel 1's launches in the mode V3: stage 1 through
    space_stage_core.cuh (no mma.sync stage 1), the q2 GEMM and stage 2;
    the old one-launch sources are gone and nothing builds them."""
    from focus_tpu_torch.ops import _build

    src = _source("trajectory_block.cu")
    for symbol in ("traj_core_v3_bf16", "traj_core_v7_bf16"):
        body = src[src.index(f'extern "C" int {symbol}('):]
        body = body[:body.index("\n}\n")]
        assert "traj_core_run<true>(" in body
    run = src[src.index("int traj_core_run("):src.index("}  // namespace")]
    assert "launch_space_stage_keys<V3>(" in run
    assert "launch_stage1" not in src and "traj_stage1_kernel" not in src
    assert '#include "space_stage_core.cuh"' in src
    core = _source("space_stage_core.cuh")
    assert "template <int NP, bool V3>" in core
    assert "if constexpr (V3)" in core
    for gone in ("trajectory_block_v3.cu", "trajectory_block_v7.cu",
                 "trajectory_stage2.cuh"):
        assert not os.path.exists(os.path.join(CSRC, gone))
    assert not {"trajectory_block_v3", "trajectory_block_v7"} & set(
        _build.SOURCES)


@pytest.mark.parametrize("launch", ["_launch_v3", "_launch_v7"])
def test_v3_wrappers_refuse_before_any_build(launch, monkeypatch):
    """float32 operands raise TypeError and N > 512 ValueError before the
    library is built or bound, and no counter moves."""
    from focus_tpu_torch.ops import _build

    def no_build(*a, **k):
        raise AssertionError("kernel built for a refused call")

    monkeypatch.setattr(_build, "bind", no_build)
    fn = getattr(ttb, launch)
    counts = (ttb.V3_LAUNCHES, ttb.V3_DEVICE_LAUNCHES, ttb.V7_LAUNCHES,
              ttb.V7_DEVICE_LAUNCHES)
    args = [torch.from_numpy(a) for a in core_inputs(B=1, F=2, N=8, C=C)]
    with pytest.raises(TypeError, match="float32 mode is open"):
        fn(*args[:6], 0.125, HEADS)
    args = _bf16(core_inputs(B=1, F=1, N=513, C=C))
    with pytest.raises(ValueError, match="N <= 512"):
        fn(*args[:6], 0.125, HEADS)
    assert (ttb.V3_LAUNCHES, ttb.V3_DEVICE_LAUNCHES, ttb.V7_LAUNCHES,
            ttb.V7_DEVICE_LAUNCHES) == counts


def test_profile_groups_name_the_v3_stage_kernels():
    """``profile_slice.py``'s kernel groups tell the mode V3's stage
    kernels (template argument true) from kernel 1's and count each device
    kernel in one group alone."""
    from focus_tpu_torch.profile_slice import kernel_groups

    ns = "void (anonymous namespace)::"
    rows = [(ns + "space_stage_kernel<208, true>(CUtensorMap_st, int)", 12,
             2800.0),
            (ns + "space_stage_kernel<208, false>(CUtensorMap_st, int)", 12,
             2700.0),
            (ns + "traj_stage2_kernel<true>(CUtensorMap_st, int)", 12, 2600.0),
            (ns + "traj_stage2_kernel<false>(CUtensorMap_st, int)", 12,
             2300.0),
            (ns + "traj_gemm_kernel(const __nv_bfloat16*, int)", 24, 1900.0)]
    groups = kernel_groups(rows, 1)
    ms = {k: v["device_ms_per_call"] for k, v in groups.items()}
    assert ms == {"kernels 3 / 4 stage 1 (mode V3)": 2.8,
                  "kernel 1 stage 1 (flagship) / kernel 8 (learned_v)": 2.7,
                  "kernels 3 / 4 stage 2 (mode V3)": 2.6,
                  "kernel 1 stage 2": 2.3,
                  "kernel 1 / 3 / 4 q2 GEMM, kernels 5 / 6 k2v and q2 GEMMs":
                      1.9}
    assert sum(v["launches_per_call"] for v in groups.values()) == 72
