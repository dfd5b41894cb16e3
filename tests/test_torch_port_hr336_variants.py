"""Kernels 3 to 6 and 8 past 256 keys a frame on the CPU (N <= 512, the
336 crop's 441 and 445): the chunked forms' plain mirrors
(``trajectory_core_v3_mirror``, ``trajectory_core_k2v_mirror`` and
``space_stage_chunked_mirror``) against the plain versions in float32 on
the same bf16 operands, within half the card's gate; the plain versions
against the JAX package's interpret-mode Pallas kernels at N = 257 (keys
padded to 384 there); the launch plans and the entries held to the CUDA
sources; the learned-v stack's shapes at the 336 crop."""

import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu.ops.pallas import trajectory_attention as jta
from focus_tpu.ops.pallas import trajectory_block as jtb
from focus_tpu_torch.ops import attention as attn_ops
from focus_tpu_torch.ops import trajectory_attention as tta
from focus_tpu_torch.ops import trajectory_block as ttb

from tests.test_torch_port_kernels import core_inputs, extreme_inputs

CSRC = os.path.join(os.path.dirname(ttb.__file__), "..", "csrc")
CARD_GATE = 2e-2  # chip_smoke.KERNEL_TOL_REL: the kernels' gate on the card
SMEM_LIMIT = 232_448
HR_N = [257, 441, 512]  # the narrowest chunked N, the 336 crop's, the widest
K2V_PLAIN = {5: ttb.trajectory_core_v5_reference,
             6: ttb.trajectory_core_v6_reference}


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _bf16_args(N, heads=2, F=8, seed=None):
    """B=1, F frames, ``heads`` heads of 64 at N keys a frame, bf16, from
    numpy's RandomState (the card's core_inputs scales)."""
    rs = np.random.RandomState(N if seed is None else seed)
    C = 64 * heads
    args = [rs.randn(1, F * N, C), rs.randn(1, F, N, C), rs.randn(1, F, N, C),
            rs.randn(C, C) * 3 * C ** -0.5, rs.randn(C) * 0.1,
            rs.randn(C, C) * 3 * C ** -0.5, rs.randn(C) * 0.1]
    return [torch.from_numpy(a.astype(np.float32)).bfloat16() for a in args]


def _extreme_bf16(sign, mag, N=441):
    args, scale = extreme_inputs(sign, mag, F=2, N=N, C=128, heads=2)
    return [torch.from_numpy(a).bfloat16() for a in args], scale


def _rel(out, ref):
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    return ((out - ref).abs().max() / ref.abs().max()).item()


# ---- kernels 3 and 4: the mode V3 past 256 keys ---------------------------------

@pytest.mark.parametrize("N", HR_N)
def test_v3_mirror_chunked_within_half_the_card_gate(N):
    """The chunked ``trajectory_core_v3_mirror`` (kernel 1's chunked stage
    1, then the V3 GEMM and stage 2) against ``trajectory_core_v3_reference``
    in float32 on the same bf16 operands, B=1, F=8, 2 heads: max|err|
    within half the card's gate, 1e-2 x max|ref| (measured 3.6e-3, 3.0e-3
    and 3.5e-3 x max|ref| at N = 257, 441 and 512); its xs and q2 are
    ``trajectory_core_chunked_mirror``'s exactly, as kernel 3's are kernel
    1's on the card."""
    args = _bf16_args(N)
    scale = 64 ** -0.5
    inter, chunked = {}, {}
    out = ttb.trajectory_core_v3_mirror(*args, scale, 2, intermediates=inter)
    ttb.trajectory_core_chunked_mirror(*args, scale, 2, intermediates=chunked)
    ref = ttb.trajectory_core_v3_reference(*[a.float() for a in args], scale,
                                           2)
    assert _rel(out, ref) <= CARD_GATE / 2
    assert torch.equal(inter["xs"], chunked["xs"])
    assert torch.equal(inter["q2"], chunked["q2"])


@pytest.mark.parametrize("sign,mag", [(-1.0, 60.0), (1.0, 50.0)])
def test_v3_mirror_chunked_extreme_logits(sign, mag):
    """Peaked stage-1 logits at N = 441: the online softmax across the
    chunks stays finite and within half the card's gate of the plain
    version in float32 (bf16 operands, F=2, 2 heads)."""
    args, scale = _extreme_bf16(sign, mag)
    out = ttb.trajectory_core_v3_mirror(*args, scale, 2)
    ref = ttb.trajectory_core_v3_reference(*[a.float() for a in args], scale,
                                           2)
    assert _rel(out, ref) <= CARD_GATE / 2


# ---- kernels 5 and 6: the chunked own-frame launch and pass ----------------------

@pytest.mark.parametrize("version", [5, 6])
@pytest.mark.parametrize("N", HR_N)
def test_k2v_mirror_chunked_within_half_the_card_gate(version, N):
    """The chunked ``trajectory_core_k2v_mirror`` (a frame's keys in two
    chunks, P rounded unnormalised, O and Y rescaled online and scaled by
    1 / l) against its version's plain version in float32 on the same bf16
    operands, B=1, F=8, 2 heads: max|err| within half the card's gate (the
    plain versions hold the TPU kernels' function, defect 5 included;
    measured 2.6e-3 to 2.9e-3 x max|ref| for v5, 3.3e-3 to 4.2e-3 for
    v6). v6's own-frame xs is the
    x_diag that q2 reads, exactly, as on the card."""
    args = _bf16_args(N)
    scale = 64 ** -0.5
    inter = {}
    out = ttb.trajectory_core_k2v_mirror(*args, scale, 2, version,
                                         intermediates=inter)
    ref = K2V_PLAIN[version](*[a.float() for a in args], scale, 2)
    assert _rel(out, ref) <= CARD_GATE / 2
    assert "p_bf16" not in inter  # no normalised P in the chunked form
    assert torch.equal(attn_ops.take_diagonal(inter["xs"], 8),
                       inter["x_diag"])


@pytest.mark.parametrize("version", [5, 6])
def test_k2v_mirror_chunked_extreme_logits(version):
    """Peaked stage-1 logits at N = 441 (bf16 operands, F=2, 2 heads): the
    chunked k2v mirror stays finite and within half the card's gate of its
    plain version in float32."""
    args, scale = _extreme_bf16(-1.0, 60.0)
    out = ttb.trajectory_core_k2v_mirror(*args, scale, 2, version)
    ref = K2V_PLAIN[version](*[a.float() for a in args], scale, 2)
    assert _rel(out, ref) <= CARD_GATE / 2


# ---- kernel 8: the chunked space stage -------------------------------------------

def _stage_args(N, BH=2, F=8, d=64, seed=0):
    rs = np.random.RandomState(seed + N)
    q = rs.randn(BH, F * N, d)
    k, v = rs.randn(BH, F, N, d), rs.randn(BH, F, N, d)
    return [torch.from_numpy(a.astype(np.float32)).bfloat16()
            for a in (q, k, v)]


@pytest.mark.parametrize("N", HR_N)
def test_space_stage_chunked_mirror_within_half_the_card_gate(N):
    """``space_stage_chunked_mirror`` against ``attn_ops.space_stage`` in
    float32 on the same bf16 operands (BH=2, F=8, d=64): max|err| within
    half the card's gate (measured 1.8e-3, 1.5e-3 and 2.2e-3 x max|ref| at
    N = 257, 441 and 512)."""
    q, k, v = _stage_args(N)
    scale = 64 ** -0.5
    out = tta.space_stage_chunked_mirror(q, k, v, scale)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 8 * N, 8, 64)
    ref = attn_ops.space_stage(q.float(), k.reshape(2, -1, 64).float(),
                               v.reshape(2, -1, 64).float(), 8, scale)
    assert _rel(out, ref) <= CARD_GATE / 2


def test_space_stage_chunked_mirror_extreme_logits():
    """Peaked logits at N = 441, one head of 64 channels: finite and within
    half the card's gate of the plain version in float32."""
    args, scale = extreme_inputs(-1.0, 60.0, B=2, F=2, N=441, C=64, heads=1)
    q, kf, vf = [torch.from_numpy(a).bfloat16() for a in args[:3]]
    out = tta.space_stage_chunked_mirror(q, kf, vf, scale)
    ref = attn_ops.space_stage(q.float(), kf.reshape(2, -1, 64).float(),
                               vf.reshape(2, -1, 64).float(), 2, scale)
    assert _rel(out, ref) <= CARD_GATE / 2


def test_chunked_stage1_is_one_function_for_kernels_1_and_8():
    """Kernel 1's chunked stage 1 is kernel 8's at one head a row:
    ``trajectory_core_chunked_mirror``'s xs, head by head, is
    ``space_stage_chunked_mirror``'s output, exactly."""
    args = _bf16_args(300, F=2)
    scale = 64 ** -0.5
    inter = {}
    ttb.trajectory_core_chunked_mirror(*args, scale, 2, intermediates=inter)
    q, kf, vf = args[:3]
    S, N = q.shape[1], 300

    def rows(t):
        lead = t.shape[1:-1]
        return t.reshape(1, *lead, 2, 64).movedim(-2, 1).reshape(2, *lead, 64)

    out = tta.space_stage_chunked_mirror(rows(q), rows(kf), rows(vf), scale)
    xs = out.reshape(1, 2, S, 2, 64).permute(0, 2, 3, 1, 4).reshape(
        1, S, 2, 128)
    assert N > tta.MAX_KEYS and torch.equal(xs, inter["xs"])


# ---- the plain versions against the JAX kernels past 256 keys --------------------

@pytest.mark.parametrize("version", [3, 5, 6])
def test_variant_plain_versions_match_pallas_interpret_at_257_keys(version):
    """At N = 257 (the JAX kernels pad the keys to 384), B=1, F=2, C=16 in
    4 heads, on tests/test_fused_block.py:make_inputs' scales (logits far
    from the TPU kernels' exp2 clamp, ROADMAP.md section 3 defect 2): the
    v3 plain version against ``_fused_fwd_pallas`` under ``KERNEL_FLAGS``,
    v5 and v6 against ``_fused_fwd_pallas_v5`` / ``_v6``, in interpret
    mode, float32, atol 2e-5 (tests/test_torch_port_variants.py's)."""
    heads = 4
    args = core_inputs(B=1, F=2, N=257, C=16, seed=5)
    scale = (16 // heads) ** -0.5
    pallas = {3: jtb._fused_fwd_pallas, 5: jtb._fused_fwd_pallas_v5,
              6: jtb._fused_fwd_pallas_v6}[version]
    plain = {3: ttb.trajectory_core_v3_reference, **K2V_PLAIN}[version]
    ref = pallas(*map(jnp.asarray, args), scale, heads, interpret=True)
    out = plain(*map(torch.from_numpy, args), scale, heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_space_stage_plain_version_matches_pallas_interpret_at_257_keys():
    """``attn_ops.space_stage`` against ``_space_stage_fwd_pallas`` in
    interpret mode at N = 257 (keys padded to 384 there), BH=2, F=2, d=16,
    float32, atol 1e-5 (tests/test_torch_port_learnedv.py's)."""
    rs = np.random.RandomState(3)
    BH, F, N, d = 2, 2, 257, 16
    q, k, v = ((rs.randn(BH, F * N, d) * 0.5).astype(np.float32)
               for _ in range(3))
    scale = d ** -0.5
    ref = jta._space_stage_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k.reshape(BH, F, N, d)),
        jnp.asarray(v.reshape(BH, F, N, d)), scale, interpret=True)
    out = attn_ops.space_stage(*map(torch.from_numpy, (q, k, v)), F, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


# ---- the plans and the entries against the CUDA sources --------------------------

@pytest.mark.parametrize("N", HR_N)
def test_chunked_plans_match_the_cuda_source(N):
    """Past 256 keys each plan is the chunked form's, from the sources'
    constants and rules: kernel 8's and kernels 3 and 4's stage 1 are
    ``chunked_stage1_plan`` (kernel 1's), two chunks of ``chunk_keys`` keys;
    kernels 5 and 6's pass holds K, V and k2v of one chunk a slot, one Q
    tile and one staging tile a warpgroup, two slots within the card's
    shared memory."""
    core = _source("space_stage_core.cuh")
    const = dict(re.findall(r"constexpr int (SS_\w+) = ([^;]+);", core))
    assert int(const["SS_MAX_NP"]) == tta.MAX_KEYS
    assert int(const["SS_MAX_KEYS"]) == tta.MAX_KEYS_CHUNKED
    assert int(const["SS_CHUNKS"]) == tta.STAGE1_CHUNKS
    assert "return n <= 448 ? 224 : 256;" in core
    cw = tta.chunk_keys(N)
    B, F, heads = 4, 8, 12
    S = F * N
    stage1 = tta.chunked_stage1_plan(B * heads, S, F, N)
    assert tta.space_stage_plan(B * heads, S, F, N) == stage1
    v3 = ttb.trajectory_core_plan(B, S, F, N, heads, v3=True)
    assert v3["stage1"] == stage1 and v3["stage2"]["g_parts"] == 2
    assert stage1["chunk_keys"] == cw and stage1["padded_keys"] == 2 * cw
    p = ttb.k2v_pass_plan(N)
    k2v = _source("trajectory_k2v.cuh")
    assert "kp_slots(int np) { return np > 208 ? 1 : 2; }" in k2v
    assert "return 3 * np * SS_ROW_BYTES;" in k2v
    assert "kp_stages(224) >= 2" in k2v
    fixed = 1024 + 128 * 128 + 2 * 64 * 128 + 1024  # one Q and staging tile
    assert (p["chunk_keys"], p["chunks"], p["slots"]) == (cw, 2, 1)
    assert p["stage_bytes"] == 3 * cw * 128 and p["stages"] == 2
    assert p["smem_bytes"] == fixed + 2 * p["stage_bytes"] <= SMEM_LIMIT


def test_entries_take_512_keys_in_every_kernel():
    """The C entries of kernel 8, kernels 1, 3 and 4 (one host function in
    both roundings) and kernels 5 and 6 check N <= SS_MAX_KEYS and run the
    chunked forms past SS_MAX_NP; the own-frame mode takes the chunked
    form (its static_assert forbids only the rounding mode V3 there)."""
    ss = _source("trajectory_attention.cu")
    assert "N > SS_MAX_KEYS ||" in ss
    assert ("if (N > SS_MAX_NP)\n"
            "    return (int)launch_space_stage_chunked(") in ss
    k1 = _source("trajectory_block.cu")
    assert "N > SS_MAX_KEYS ||" in k1 and "max_keys" not in k1
    assert ("err = N > SS_MAX_NP\n"
            "            ? launch_space_stage_chunked(") in k1
    # one launcher of the chunked form, in the shared header
    assert "cudaError_t launch_space_stage_chunked(" not in k1
    k2v = _source("trajectory_k2v.cuh")
    assert "N > SS_MAX_KEYS ||" in k2v
    assert "if (N > SS_MAX_NP)\n    return ss_chunk_keys(N) == 224" in k2v
    assert "ss_chunk_weights<NP>(sacc, pa, N - c * NP, c == 0" in k2v
    core = _source("space_stage_core.cuh")
    assert 'static_assert(CH == 1 || !V3, "the chunked form rounds as V3' \
        in core
    assert "inline cudaError_t launch_space_stage_chunked(" in core


# ---- the learned-v stack at the 336 crop ----------------------------------------

def test_learned_v_stack_at_the_336_crop_shapes(monkeypatch):
    """``learned_v_stack(hr=True)`` on the meta device (no weights drawn):
    12 blocks of D=768 at thw (8, 21, 21), x [batch, 1 + 8 * 21 * 21, 768]
    bf16; ``tiny`` keeps its CPU shapes."""
    from focus_tpu_torch import profile_block

    monkeypatch.setattr(profile_block, "init_weights", lambda *a, **k: None)
    monkeypatch.setattr(profile_block.torch, "Generator",
                        lambda device=None: types.SimpleNamespace(
                            manual_seed=lambda seed: None))
    model, x = profile_block.learned_v_stack(device="meta", batch=3, hr=True)
    assert model.thw == (8, 21, 21) and len(model.blocks) == 12
    assert tuple(x.shape) == (3, 3529, 768) and x.dtype == torch.bfloat16
    _, x224 = profile_block.learned_v_stack(device="meta", batch=3)
    assert tuple(x224.shape) == (3, 1569, 768)
    monkeypatch.undo()
    tiny, xt = profile_block.learned_v_stack(device="cpu", batch=2, tiny=True,
                                             hr=True)
    assert tiny.thw == (2, 2, 2) and tuple(xt.shape) == (2, 9, 32)
