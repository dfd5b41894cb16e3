"""The HR-336 EPIC-Kitchens eval forward on the CPU: the bicubic
position-embedding resize, the verb / noun heads and the tiny HR model
against the JAX package on the same numpy inputs and weights; kernel 1's
chunked stage 1 (N > 256 keys a frame) through its plain mirror
(``ops/trajectory_block.trajectory_core_chunked_mirror``) against the
interpret-mode Pallas kernel, ``_xla_reference`` and the plain version; its
launch plan held to the CUDA source's constants; every kernel's wrapper
taking N <= 512 and refusing 513 before any build."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu.models.motionformer import (
    interpolate_pos_embed as jax_interpolate_pos_embed,
)
from focus_tpu.ops.pallas import trajectory_block as jtb
from focus_tpu_torch.config import get_cfg
from focus_tpu_torch.entry import hr_cfg, hr_entry
from focus_tpu_torch.models.build import build_model
from focus_tpu_torch.models.motionformer import interpolate_pos_embed
from focus_tpu_torch.ops import trajectory_attention as tta
from focus_tpu_torch.ops import trajectory_block as ttb
from focus_tpu_torch.utils.weights import load_jax_params
from tests.test_torch_port_kernels import core_inputs, extreme_inputs
from tests.test_torch_port_models import load, mf_full_cfg
from tests.test_torch_port_train import jax_cfg

CSRC = os.path.join(os.path.dirname(ttb.__file__), "..", "csrc")
SMEM_LIMIT = 232_448
CARD_GATE = 2e-2  # chip_smoke.KERNEL_TOL_REL: the kernels' gate on the card


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


# ---- the position-embedding resize -----------------------------------------------

@pytest.mark.parametrize("side_in,side,dim", [
    (14, 21, 768),  # the flagship's grid at the 336 crop
    (4, 6, 24),     # the tiny HR model's
    (14, 7, 8),     # a downscale: JAX's antialiased kernel
    (14, 14, 8),    # the 224 crop: the identity
])
def test_pos_embed_resize_matches_jax(side_in, side, dim):
    """``interpolate_pos_embed`` against the JAX package's
    (``jax.image.resize``, bicubic) on the same float32 grid, atol 1e-5
    (JAX builds its weights in float32, the port in float64; measured
    4.5e-6 at 14 -> 21 against max|ref| 5.1); the CLS row passes through
    and an unchanged grid is returned as it is."""
    pe = np.random.RandomState(side * 31 + dim).randn(
        1, side_in * side_in + 1, dim).astype(np.float32)
    ref = np.asarray(jax_interpolate_pos_embed(jnp.asarray(pe), side * side))
    out = interpolate_pos_embed(torch.from_numpy(pe), side * side)
    assert tuple(out.shape) == (1, side * side + 1, dim)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    np.testing.assert_array_equal(out[:, 0].numpy(), pe[:, 0])
    if side == side_in:
        assert torch.equal(out, torch.from_numpy(pe))


# ---- the EPIC-Kitchens heads -------------------------------------------------------

def test_ek_model_matches_the_reference_fixture():
    """The port's EPIC-Kitchens Motionformer (heads ``head0`` and
    ``head1``) on the reference's state_dict, strict: verb and noun
    probabilities against the reference's at the JAX test's 2e-5."""
    d, sd = load("motionformer_ek_full")
    cfg = mf_full_cfg(get_cfg)
    cfg.TRAIN.DATASET = "epickitchens"
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    video = torch.from_numpy(d["video"].transpose(0, 2, 3, 4, 1).copy())
    with torch.no_grad():
        verb, both = model(video, {})
    assert verb is both["verb"]
    np.testing.assert_allclose(both["verb"].numpy(), d["out_verb"], atol=2e-5)
    np.testing.assert_allclose(both["noun"].numpy(), d["out_noun"], atol=2e-5)


def test_ek_heads_in_training_return_logits():
    """``train=True`` skips the softmax, as the JAX model does: the pair
    holds logits whose softmax is the eval output (stochastic depth off, so
    that the two forwards compute the same features)."""
    cfg = hr_cfg(tiny=True)
    cfg.MF.DROP_PATH = 0.0
    model = build_model(cfg, device="cpu")
    _, (video, boxes) = hr_entry(device="cpu", batch=2, tiny=True)
    meta = {"orvit_bboxes": boxes}
    with torch.no_grad():
        probs = model(video, meta)[1]
        logits = model(video, meta, train=True)[1]
    for name, n in (("verb", 97), ("noun", 300)):
        assert tuple(logits[name].shape) == (2, n)
        torch.testing.assert_close(torch.softmax(logits[name], -1),
                                   probs[name], rtol=0, atol=1e-6)


# ---- the tiny HR model against the JAX model -------------------------------------------

def test_tiny_hr_model_matches_jax_model_on_same_weights():
    """hr_cfg(tiny=True) (D=24, 3 layers, ORViT at [1], 56-pixel patches at
    the 336 crop, so a 4 x 4 position grid resized to 6 x 6; float32): JAX
    init -> weight bridge -> port, verb and noun probabilities on video
    [2, 4, 336, 336, 3] at the tolerance of
    test_torch_port_models.py::test_slice_matches_jax_model_on_same_weights
    (2e-5), the same top-1."""
    from focus_tpu.models.build import build_model as jax_build_model
    from focus_tpu.models.build import init_model

    cfg = hr_cfg(tiny=True)
    jcfg = jax_cfg(cfg)
    rs = np.random.RandomState(5)
    video = rs.rand(2, 4, 336, 336, 3).astype(np.float32)
    boxes = (rs.rand(2, 2, cfg.ORVIT.O, 4) * 0.5 + 0.25).astype(np.float32)
    jmodel = jax_build_model(jcfg)
    jmeta = {"orvit_bboxes": jnp.asarray(boxes)}
    variables = init_model(jmodel, jcfg, (jnp.asarray(video), jmeta),
                           rng=jax.random.PRNGKey(5))
    params = jax.device_get(variables["params"])
    _, ref = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(video),
                                   jmeta)
    model = build_model(cfg, device="cpu")
    load_jax_params(model, params)
    with torch.no_grad():
        _, out = model(torch.from_numpy(video),
                       {"orvit_bboxes": torch.from_numpy(boxes)})
    for name, n in (("verb", 97), ("noun", 300)):
        got, want = out[name].numpy(), np.asarray(ref[name])
        assert got.shape == (2, n)
        np.testing.assert_allclose(got, want, atol=2e-5)
        assert (got.argmax(-1) == want.argmax(-1)).all()


def test_hr_entry_on_the_cpu():
    """The entry point's tiny model and inputs: the 336 crop, 36 patches a
    frame (the resized grid), boxes of O = 4, probabilities summing to 1."""
    fn, (video, boxes) = hr_entry(device="cpu", batch=2, tiny=True)
    assert tuple(video.shape) == (2, 4, 336, 336, 3)
    assert tuple(boxes.shape) == (2, 2, 4, 4)
    assert fn.model.pos_embed.shape[1] == 17
    verb, both = fn(video, boxes)
    assert verb is both["verb"]
    for name, n in (("verb", 97), ("noun", 300)):
        p = both[name]
        assert tuple(p.shape) == (2, n) and torch.isfinite(p).all()
        torch.testing.assert_close(p.sum(-1), torch.ones(2))
    full = hr_cfg()
    assert (full.DATA.TRAIN_CROP_SIZE, full.MF.PATCH_SIZE, full.MF.EMBED_DIM,
            full.MF.DEPTH, full.ORVIT.LAYERS) == (336, 16, 768, 12, [1, 6, 10])


# ---- kernel 1's chunked stage 1: its mirror ----------------------------------------------

def test_chunked_mirror_matches_pallas_v4_interpret():
    """The mirror at N = 300 (two chunks of 224: 224 + 76 keys) against the
    JAX package's v4 kernel in interpret mode (keys padded to 384 there),
    B=1, F=2, 2 heads, float32: atol 2e-5 (float32 has no rounding point to
    move; measured 2e-7 against the plain version)."""
    heads = 2
    args = core_inputs(B=1, F=2, N=300, C=64 * heads, seed=11)
    scale = 64 ** -0.5
    ref = jtb._fused_fwd_pallas_v4(*map(jnp.asarray, args), scale, heads,
                                   interpret=True)
    out = ttb.trajectory_core_chunked_mirror(*map(torch.from_numpy, args),
                                             scale, heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("sign,mag", [(-1.0, 60.0), (1.0, 50.0)])
def test_chunked_mirror_extreme_logits(sign, mag):
    """Peaked stage-1 logits at N = 441 (the 336 crop): the online softmax
    across the chunks stays finite and matches the XLA composition at 5e-4,
    as the plain version does (``test_trajectory_core_extreme_logits``)."""
    args, scale = extreme_inputs(sign, mag, F=2, N=441, C=128, heads=2)
    ref = jtb._xla_reference(*map(jnp.asarray, args), scale, 2)
    out = ttb.trajectory_core_chunked_mirror(*map(torch.from_numpy, args),
                                             scale, 2)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4)


@pytest.mark.parametrize("N", [257, 441, 512])
def test_chunked_mirror_bf16_within_half_the_card_gate(N):
    """In bf16, the chunked form's rounding (the stage-1 weights rounded
    before they are normalised) against the plain version in float32 on the
    same bf16 operands, B=1, F=8, 2 heads: max|err| within half the card's
    gate, 1e-2 x max|ref| (measured 4.6e-3, 4.4e-3 and 4.4e-3 at N = 257,
    441 and 512, where the bf16 plain version reads 4.0e-3, 4.7e-3 and
    4.8e-3)."""
    rs = np.random.RandomState(N)
    C, F = 128, 8
    args = [rs.randn(1, F * N, C), rs.randn(1, F, N, C), rs.randn(1, F, N, C),
            rs.randn(C, C) * 3 * C ** -0.5, rs.randn(C) * 0.1,
            rs.randn(C, C) * 3 * C ** -0.5, rs.randn(C) * 0.1]
    args = [torch.from_numpy(a.astype(np.float32)).bfloat16() for a in args]
    scale = 64 ** -0.5
    out = ttb.trajectory_core_chunked_mirror(*args, scale, 2).float()
    ref = ttb.trajectory_core_reference(*[a.float() for a in args], scale, 2)
    assert (out - ref).abs().max() <= CARD_GATE / 2 * ref.abs().max()


# ---- kernel 1's chunked stage 1: its plan ------------------------------------------------

@pytest.mark.parametrize("N,chunk,stages", [(257, 224, 3), (441, 224, 3),
                                            (445, 224, 3), (512, 256, 2)])
def test_chunked_stage1_plan(N, chunk, stages):
    """Two chunks a frame that cover its keys, at most 256 each (one
    instantiated wgmma width), at least two ring slots (three at the 336
    crop's N), one output staging tile a warpgroup, within the card's
    shared memory; kernel 1's plan takes it, and so do kernel 8's and
    kernels 3 and 4's (their stage 1 is the same chunked kernel)."""
    B, F, heads = 4, 8, 12
    S = F * N
    p = tta.chunked_stage1_plan(B * heads, S, F, N)
    assert (p["chunk_keys"], p["stages"], p["chunks"]) == (chunk, stages, 2)
    assert p["chunks"] * p["chunk_keys"] >= N > p["chunk_keys"]
    assert p["chunk_keys"] <= tta.MAX_KEYS and p["chunk_keys"] % 16 == 0
    assert p["smem_bytes"] <= SMEM_LIMIT and p["stages"] >= 2
    assert p["out_slots"] == 1 and p["grid"] == 132
    plan = ttb.trajectory_core_plan(B, S, F, N, heads)
    assert plan["stage1"] == p and plan["device_launches"] == 3
    assert plan["stage2"]["smem_bytes"] <= SMEM_LIMIT
    assert plan["stage2"]["blocks"] * plan["stage2"]["rows_per_block"] >= B * S
    v3 = ttb.trajectory_core_plan(B, S, F, N, heads, v3=True)
    assert v3["stage1"] == p and v3["rounding"] == "v3"
    assert tta.space_stage_plan(B * heads, S, F, N) == p


def test_chunked_stage1_plan_matches_the_cuda_source():
    """The plan's constants and rules are the kernel's."""
    src = _source("space_stage_core.cuh")
    const = dict(re.findall(r"constexpr int (SS_\w+) = ([^;]+);", src))
    assert const["SS_MAX_KEYS"] == str(ttb.MAX_KEYS_CHUNKED)
    assert const["SS_CHUNKS"] == str(ttb.STAGE1_CHUNKS)
    assert const["SS_MAX_NP"] == str(ttb.MAX_KEYS)
    assert "return n <= 448 ? 224 : 256;" in src
    assert [ttb.chunk_keys(n) for n in (257, 448, 449, 512)] == [224, 224,
                                                                 256, 256]
    assert "return ch > 1 ? 1 : SS_OUT_SLOTS;" in src
    assert "SS_WG * ss_out_slots(ch) * SS_OUT_BYTES + SS_BAR_BYTES" in src
    assert "static_assert(ss_stages(224, SS_CHUNKS) >= 3" in src
    assert "launch_space_stage<224, false, SS_CHUNKS>(" in src
    assert "launch_space_stage<256, false, SS_CHUNKS>(" in src
    # kernels 1, 3 and 4 (both roundings), 5, 6 and 8 take N <= 512, the
    # chunked form past 256
    k1 = _source("trajectory_block.cu")
    assert "N > SS_MAX_KEYS ||" in k1 and "max_keys" not in k1
    assert ("err = N > SS_MAX_NP\n"
            "            ? launch_space_stage_chunked(") in k1
    for name in ("trajectory_k2v.cuh", "trajectory_attention.cu"):
        assert "N > SS_MAX_KEYS ||" in _source(name)
        assert "N > SS_MAX_NP" in _source(name)
    hdr = _source("hopper_async.cuh")
    assert "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16" in hdr


# ---- the wrappers' key limits ----------------------------------------------------------

def _no_build(*a, **k):
    raise AssertionError("kernel built for a refused call")


def _meta_args(N, B=1, F=2, C=128, grad=False):
    shapes = ((B, F * N, C), (B, F, N, C), (B, F, N, C), (C, C), (C,),
              (C, C), (C,))
    return [torch.empty(*s, dtype=torch.bfloat16, device="meta",
                        requires_grad=grad) for s in shapes]


def test_kernel_1_takes_512_keys_and_refuses_513(monkeypatch):
    """The kernels' one check passes up to N = 512 keys a frame and refuses
    513, for every kernel; kernel 1's wrapper refuses 513 before any
    build."""
    monkeypatch.setattr(ttb, "_kernel_fn", _no_build)
    ttb._check_operands(*_meta_args(512)[:6], 2)
    with pytest.raises(ValueError, match="N <= 512"):
        ttb._check_operands(*_meta_args(513)[:6], 2)
    with pytest.raises(ValueError, match="N <= 512"):
        ttb._launch(*_meta_args(513)[:6], 0.125, 2)


def _launch_backward_at(N):
    """The backward wrapper on meta operands at N keys a frame (F = 2)."""
    args = _meta_args(N)
    xs = torch.empty(1, 2 * N, 2, 128, dtype=torch.bfloat16, device="meta")
    return ttb._launch_backward(*args[:6], args[0], xs, args[0], 0.125, 2)


@pytest.mark.parametrize("kernel", ["v3", "v7", "v5", "v6", "backward",
                                    "space_stage"])
def test_kernels_3_to_8_refuse_257_keys_before_any_build(monkeypatch,
                                                         kernel):
    """Kernels 3 to 8 take N <= 512 keys a frame (257 and 512 among them):
    each wrapper passes its check at 512 and reaches the build, and refuses
    513 with "N <= 512" before any build."""
    from focus_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "bind", _no_build)

    def call(N):
        args = _meta_args(N)
        return {
            "v3": lambda: ttb._launch_v3(*args[:6], 0.125, 2),
            "v7": lambda: ttb._launch_v7(*args[:6], 0.125, 2),
            "v5": lambda: ttb._launch_variant(5, *args[:6], 0.125, 2),
            "v6": lambda: ttb._launch_variant(6, *args[:6], 0.125, 2),
            "backward": lambda: _launch_backward_at(N),
            "space_stage": lambda: tta._launch(
                args[0].reshape(2, 2 * N, 64),
                args[1].reshape(2, 2, N, 64),
                args[2].reshape(2, 2, N, 64), 0.125),
        }[kernel]()

    with pytest.raises(AssertionError, match="kernel built"):
        call(512)
    with pytest.raises(ValueError, match="N <= 512"):
        call(513)


@pytest.mark.parametrize("version", [3, 4, 5, 6, 7])
def test_hr_train_step_refuses_before_the_forward_launches(monkeypatch,
                                                           version):
    """At N = 441 every version reaches its forward launch, with a
    gradient wanted (the forward kernels and the backward kernel take N <=
    512) and without one."""
    def no_launch(*a, **k):
        raise AssertionError("forward launched")

    for name in ("_launch", "_launch_v3", "_launch_v7", "_launch_variant"):
        monkeypatch.setattr(ttb, name, no_launch)
    args = _meta_args(441, grad=True)
    with pytest.raises(AssertionError, match="forward launched"):
        ttb._FusedCore.apply(*args, 0.125, 2, version)
    args = _meta_args(441)
    with pytest.raises(AssertionError, match="forward launched"):
        ttb._FusedCore.apply(*args, 0.125, 2, version)


def test_profile_groups_name_the_chunked_stage_1():
    """``profile_slice.py`` counts the chunked stage-1 kernel (kernels 1,
    3, 4 and 8 past 256 keys) in a group of its own, apart from the space
    stage's."""
    from focus_tpu_torch.profile_slice import kernel_groups

    ns = "void (anonymous namespace)::"
    rows = [(ns + "space_stage_chunked_kernel<224>(CUtensorMap_st, int)", 12,
             7000.0),
            (ns + "space_stage_kernel<208, false>(CUtensorMap_st, int)", 12,
             2700.0)]
    ms = {k: v["device_ms_per_call"] for k, v in kernel_groups(rows, 1).items()}
    assert ms == {"stage 1, chunked (N > 256, HR-336): kernels 1, 3, 4 "
                  "and 8": 7.0,
                  "kernel 1 stage 1 (flagship) / kernel 8 (learned_v)": 2.7}
