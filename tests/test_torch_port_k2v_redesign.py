"""Kernels 5 and 6 (the trajectory core's forward versions 6 and 5) on the
CPU, as the card runs them since their redesign (``csrc/trajectory_k2v.cuh``):
the k2v GEMM, the own-frame aggregates on the space stage's kernel, the q2
GEMM and one wgmma / TMA pass that reads the stage-2 logits off k2v as a
second value stream. The kernels' plain mirror
(``ops/trajectory_block.trajectory_core_k2v_mirror``) against the JAX
package's interpret-mode v5 and v6 kernels, the port's v5 / v6 plain
versions, the XLA composition on extreme logits, the M-form of the stage-2
logits and the two-pass frame softmax; the pass's launch plan held to the
CUDA source's constants; the sources' structure; and the wrappers' refusals
before any build."""

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
HEADS = 4  # at C = 16, as tests/test_torch_port_variants.py runs them
PALLAS = {5: jtb._fused_fwd_pallas_v5, 6: jtb._fused_fwd_pallas_v6}
PLAIN = {5: ttb.trajectory_core_v5_reference,
         6: ttb.trajectory_core_v6_reference}
TOL_REL = 2e-2  # the card's KERNEL_TOL_REL


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _torch(args, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in args]


def _rel(out, ref):
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    return ((out - ref).abs().max() / ref.abs().max()).item()


# ---- the mirror ----------------------------------------------------------------

@pytest.mark.parametrize("version", [5, 6])
@pytest.mark.parametrize("N", [12, 13])
def test_mirror_matches_pallas_interpret(version, N):
    """Against the TPU kernel it replaces, in interpret mode, in float32 on
    tests/test_fused_block.py:make_inputs (atol 2e-5, the variants test's
    tolerance): where nothing is rounded the one-pass form (Y_f = P .
    k2v_f, l2 = q2 . Y_f, the online frame softmax) is the TPU kernels'
    M-form function."""
    args = core_inputs(N=N)
    scale = (16 // HEADS) ** -0.5
    ref = PALLAS[version](*map(jnp.asarray, args), scale, HEADS,
                          interpret=True)
    out = ttb.trajectory_core_k2v_mirror(*_torch(args), scale, HEADS, version)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("version", [5, 6])
@pytest.mark.parametrize("inputs", ["random", "extreme -60", "extreme +50"])
def test_mirror_matches_the_plain_version_in_bf16(version, inputs):
    """The kernels' rounding points against the v5 / v6 plain versions on
    the same bf16 operands at the kernel's head dim (2 heads, C = 128, F =
    4, N = 24): within 2e-2 x max|ref|, the card's gate. Measured on these
    inputs: max|err| / max|ref| of 2.0e-3 to 4.0e-3 for v6 (it mixes the
    same bf16 xs; mean|err| / mean|ref| 7.4e-6 to 8.1e-6: only the float32
    order of l2 and the frame softmax moves) and of 4.0e-3 to 7.2e-3 for v5
    (mean 2.2e-3 to 2.5e-3: its plain version folds p a2 / s into bf16
    weights where the kernel mixes the float32 O_f). The bound holds them
    to half the gate, and v6's mean error to 1e-4."""
    heads, C = 2, 128
    if inputs == "random":
        raw, scale = core_inputs(B=2, F=4, N=24, C=C, seed=21), 64 ** -0.5
    else:
        sign, mag = (-1.0, 60.0) if inputs == "extreme -60" else (1.0, 50.0)
        raw, scale = extreme_inputs(sign, mag, F=4, N=24, C=C, heads=heads)
    args = _torch(raw, torch.bfloat16)
    out = ttb.trajectory_core_k2v_mirror(*args, scale, heads, version)
    assert out.dtype == torch.bfloat16 and out.shape == args[0].shape
    ref = PLAIN[version](*args, scale, heads)
    assert _rel(out, ref) <= TOL_REL / 2
    if version == 6:
        out, ref = out.float(), ref.float()
        assert (out - ref).abs().mean() <= 1e-4 * ref.abs().mean()


@pytest.mark.parametrize("version", [5, 6])
@pytest.mark.parametrize("sign,mag", [(-1.0, 25.0), (-1.0, 60.0),
                                      (1.0, 50.0)])
def test_mirror_extreme_logits(version, sign, mag):
    """Peaked stage-1 logits: the true per-frame max keeps the weights
    finite, and the mirror matches the max-subtracted XLA composition in
    float32 (atol 5e-4, tests/test_fused_block.py:_extreme_inputs'
    tolerance)."""
    args, scale = extreme_inputs(sign, mag)
    ref = jtb._xla_reference(*map(jnp.asarray, args), scale, HEADS)
    out = ttb.trajectory_core_k2v_mirror(*_torch(args), scale, HEADS,
                                         version).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(ref), atol=5e-4)


@pytest.mark.parametrize("N", [12, 13])
def test_stage2_logits_are_the_m_form(N):
    """The identity the pass rests on, in float32: l2_h[q, f] = q2_h . y_f,h
    with y_f,h = sum_{n in f} (p / s) k2v_h[n] equals the TPU kernels'
    sum_{n in f} p M_h / s * scale with M_h = q2_h . k2v_h^T (1e-5)."""
    args = _torch(core_inputs(N=N, seed=3))
    scale = (16 // HEADS) ** -0.5
    inter = {}
    ttb.trajectory_core_k2v_mirror(*args, scale, HEADS, 6,
                                   intermediates=inter)
    _, p, s = ttb._stage1_weights(args[0], args[1], args[2], scale, HEADS)
    B, S, C = args[0].shape
    F = args[1].shape[1]
    k2vh = inter["k2v"].reshape(B, F, N, HEADS, C // HEADS).permute(
        0, 3, 1, 2, 4)
    q2h = inter["q2"].reshape(B, S, HEADS, C // HEADS).permute(0, 2, 1, 3)
    m = torch.einsum("bhsd,bhfnd->bhsfn", q2h, k2vh)
    l2 = (p * m).sum(-1) / s * scale
    np.testing.assert_allclose(inter["l2"].numpy(), l2.numpy(), atol=1e-5)


@pytest.mark.parametrize("version", [5, 6])
def test_online_frame_softmax_is_the_two_pass_one(version):
    """The online softmax over frames (running max, sum and mix, rescaled
    per frame) against a2 = softmax_f(l2) then sum_f a2_f x_f, in float32
    (1e-6), with the stage-2 logits spread wide enough that the running max
    moves."""
    args = _torch(core_inputs(N=12, seed=8))
    args[4], args[5] = args[4] * 30, args[5] * 30  # wide stage-2 logits
    scale = (16 // HEADS) ** -0.5
    inter = {}
    ttb.trajectory_core_k2v_mirror(*args, scale, HEADS, version,
                                   intermediates=inter)
    l2 = inter["l2"]
    assert (l2.amax(-1) - l2.amin(-1)).max() > 5
    assert (l2.argmax(-1) > 0).any()  # the max is not the first frame's
    a2 = torch.softmax(l2, dim=-1)
    two_pass = torch.einsum("bhsf,bhsfd->bshd", a2, inter["o"])
    B, S, C = args[0].shape
    np.testing.assert_allclose(inter["out_f32"].numpy(),
                               two_pass.reshape(B, S, C).numpy(), atol=1e-6)


def test_mirror_at_one_head_is_the_trajectory_core():
    """With one head every head's stage-1 weights agree, so the k2v form is
    the trajectory core's function (float32, atol 1e-6)."""
    args = _torch(core_inputs(N=12, seed=5))
    for version in (5, 6):
        np.testing.assert_allclose(
            ttb.trajectory_core_k2v_mirror(*args, 0.25, 1, version).numpy(),
            ttb.trajectory_core_reference(*args, 0.25, 1).numpy(), atol=1e-6)


def test_mirror_refuses_other_versions():
    args = _torch(core_inputs())
    with pytest.raises(ValueError, match="versions 5 and 6"):
        ttb.trajectory_core_k2v_mirror(*args, 0.5, HEADS, 4)


# ---- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("N", [1, 64, 65, 128, 196, 200, 208, 256])
def test_k2v_plan_fits(N):
    """Every padded width keeps at least two frame slots of K, V and k2v
    beside the Q tiles and the xs staging tiles, within the card's shared
    memory, as the own-frame launch (the space stage's plan) does."""
    from focus_tpu_torch.ops import trajectory_attention as ta

    p = ttb.k2v_pass_plan(N)
    assert p["padded_keys"] >= N and p["padded_keys"] in (64, 128, 208, 256)
    assert 2 <= p["stages"] <= 4 and p["smem_bytes"] <= SMEM_LIMIT
    assert p["slots"] == (1 if N > 208 else 2)
    own_frame = ta.space_stage_plan(8 * 12, 8 * N, 8, N)
    assert own_frame["smem_bytes"] <= SMEM_LIMIT


@pytest.mark.parametrize("N,slots,stages,smem", [
    (64, 2, 4, 165_888), (128, 2, 3, 215_040), (196, 2, 2, 227_328),
    (256, 1, 2, 231_424)])
def test_k2v_plan_at_each_width(N, slots, stages, smem):
    p = ttb.k2v_pass_plan(N)
    assert (p["slots"], p["stages"], p["smem_bytes"]) == (
        slots, stages, smem)


def test_k2v_plan_refuses_what_the_kernels_do_not_take():
    for N in (0, 513):
        with pytest.raises(ValueError, match="N <= 512"):
            ttb.k2v_pass_plan(N)


def test_k2v_plan_matches_the_cuda_source():
    """The Python plan's constants are the CUDA source's."""
    core = _source("space_stage_core.cuh")
    const = dict(re.findall(r"constexpr int (SS_\w+) = ([^;]+);", core))
    assert const["SS_SMEM_LIMIT"] == str(SMEM_LIMIT)
    assert const["SS_MAX_STAGES"] == "4" and const["SS_ALIGN"] == "1024"
    assert const["SS_BAR_BYTES"] == "1024" and const["SS_WG"] == "2"
    assert const["SS_ROWS"] == "64 * SS_WG"
    assert ttb.K2V_PASS_ROWS == 128
    src = _source("trajectory_k2v.cuh")
    assert "kp_slots(int np) { return np > 208 ? 1 : 2; }" in src
    assert "constexpr int QS = kp_slots(NP), OS = QS;" in src
    assert "return 3 * np * SS_ROW_BYTES;  // K_f, V_f and k2v_f" in src
    assert ("return SS_ALIGN + kp_slots(np) * SS_Q_BYTES +\n"
            "         SS_WG * kp_slots(np) * SS_OUT_BYTES + SS_BAR_BYTES;"
            ) in src
    assert "SS_MAX_STAGES\n             ? (SS_SMEM_LIMIT - kp_fixed_bytes(np))" \
        in src
    assert "constexpr int smem = k2v_pass_smem_bytes(NP);" in src
    assert "return n <= 64 ? 64 : (n <= 128 ? 128 : (n <= 208 ? 208 : 256));" \
        in core


# ---- the sources ---------------------------------------------------------------

def test_k2v_sources_hold_the_new_design_alone():
    """v5 and v6 include trajectory_k2v.cuh, which runs the own-frame
    aggregates on the space stage's kernel and the pass on wgmma and TMA;
    the mma.sync stage 1 and the M-form stage 2 are gone; four launches a
    call, each counted."""
    tc = _source("trajectory_core.cuh")
    for gone in ("traj_stage1_kernel", "launch_stage1", "stage1_smem",
                 "stage1_krows", "S1_ROWS", "LDH"):
        assert gone not in tc
    src = _source("trajectory_k2v.cuh")
    for gone in ("traj_k2v_stage2_kernel", "launch_k2v_stage2", "pass B"):
        assert gone not in src
    assert '#include "space_stage_core.cuh"' in src
    assert "launch_own_frame<NP, CH>(" in src
    assert "k2v_pass_kernel<NP, V5, CH><<<" in src
    assert "wgmma_ss<NP>(sacc" in src and "wgmma_rs_n64_tb(yacc" in src
    assert "ss_frame_softmax<NP, false>(" in src
    # two ping-pong turns a frame: the logits, then both products
    assert src.count("named_barrier(3 + wg, 256);") == 2
    assert src.count("++*launched") == 4
    host = src[src.index("int traj_core_k2v("):]
    assert host.count("launch_gemm(") == 1  # k2v; q2's is in launch_k2v_keys
    assert "own_frame_kernel(" in src
    assert "space_stage_body<NP, false, true, CH>(" in src
    core = _source("space_stage_core.cuh")
    assert "space_stage_body<NP, V3, false>(" in core
    assert "if constexpr (DIAG)" in core
    for v in (5, 6):
        cu = _source(f"trajectory_block_v{v}.cu")
        assert '#include "trajectory_k2v.cuh"' in cu
        assert f"traj_core_k2v<{'true' if v == 5 else 'false'}>(" in cu
        assert "0.1219 ms" in cu and "0.0930 ms" in cu


@pytest.mark.parametrize("version", [5, 6])
def test_k2v_wrappers_refuse_before_any_build(version, monkeypatch):
    """float32 operands raise TypeError and N > 512 ValueError before the
    library is built or bound, and no counter moves."""
    from focus_tpu_torch.ops import _build

    def no_build(*a, **k):
        raise AssertionError("kernel built for a refused call")

    monkeypatch.setattr(_build, "bind", no_build)
    counts = (ttb.V5_LAUNCHES, ttb.V5_DEVICE_LAUNCHES, ttb.V6_LAUNCHES,
              ttb.V6_DEVICE_LAUNCHES)
    args = _torch(core_inputs(B=1, F=2, N=8, C=128))
    with pytest.raises(TypeError, match="float32 mode is open"):
        ttb._launch_variant(version, *args[:6], 0.125, 2)
    args = _torch(core_inputs(B=1, F=1, N=513, C=128), torch.bfloat16)
    with pytest.raises(ValueError, match="N <= 512"):
        ttb._launch_variant(version, *args[:6], 0.125, 2)
    assert (ttb.V5_LAUNCHES, ttb.V5_DEVICE_LAUNCHES, ttb.V6_LAUNCHES,
            ttb.V6_DEVICE_LAUNCHES) == counts


def test_profile_groups_name_the_k2v_kernels():
    """``profile_slice.py``'s kernel groups tell kernels 5 and 6's
    own-frame launch and pass apart from the space stage, and count the
    GEMMs of every version in one group."""
    from focus_tpu_torch.profile_slice import kernel_groups

    ns = "void (anonymous namespace)::"
    rows = [(ns + "own_frame_kernel<208, 1>(CUtensorMap_st, int)", 12,
             500.0),
            (ns + "k2v_pass_kernel<208, true, 1>(CUtensorMap_st, int)", 12,
             3000.0),
            (ns + "k2v_pass_kernel<208, false, 1>(CUtensorMap_st, int)", 12,
             3300.0),
            (ns + "own_frame_kernel<224, 2>(CUtensorMap_st, int)", 12,
             900.0),
            (ns + "k2v_pass_kernel<224, true, 2>(CUtensorMap_st, int)", 12,
             7000.0),
            (ns + "k2v_pass_kernel<224, (bool)0, 2>(CUtensorMap_st, int)",
             12, 7500.0),
            (ns + "space_stage_kernel<208, false>(CUtensorMap_st, int)", 12,
             2700.0),
            (ns + "traj_gemm_kernel(const __nv_bfloat16*, int)", 24, 1900.0)]
    ms = {k: v["device_ms_per_call"]
          for k, v in kernel_groups(rows, 1).items()}
    assert ms == {"kernels 5 / 6 own-frame x_diag": 0.5,
                  "kernel 6 pass (v5)": 3.0, "kernel 5 pass (v6)": 3.3,
                  "kernels 5 / 6 own-frame x_diag, chunked": 0.9,
                  "kernel 6 pass (v5), chunked": 7.0,
                  "kernel 5 pass (v6), chunked": 7.5,
                  "kernel 1 stage 1 (flagship) / kernel 8 (learned_v)": 2.7,
                  "kernel 1 / 3 / 4 q2 GEMM, kernels 5 / 6 k2v and q2 GEMMs":
                      1.9}
