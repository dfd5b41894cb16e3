"""The HR-336 EPIC-Kitchens train step on the CPU against the JAX package on
the same numpy inputs: ``ek_loss``; the backward kernel's plain mirror
(``ops/trajectory_block.trajectory_core_backward_mirror``) in the chunked
dq kernel's order at N > 256 keys a frame against ``jax.vjp`` of
``_xla_reference`` at the card's gate and against the interpret-mode
Pallas backward; the tiny HR model's loss and gradients and three train
steps on verb and noun labels; ``hr_train_entry``; and the chunked dq
kernel's limits held to the CUDA source."""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu.ops.pallas import trajectory_block as jtb
from focus_tpu_torch.entry import hr_train_cfg, hr_train_entry
from focus_tpu_torch.models.build import build_model
from focus_tpu_torch.ops import trajectory_block as ttb
from focus_tpu_torch.utils.weights import (
    jax_grads_to_state_dict,
    jax_params_to_state_dict,
    load_jax_params,
)
from tests.test_torch_port_kernels import core_inputs, extreme_inputs
from tests.test_torch_port_train import jax_cfg

CSRC = os.path.join(os.path.dirname(ttb.__file__), "..", "csrc")
HEADS = 2
# the card's gate for the backward kernel (chip_smoke.py KERNEL_TOL_REL,
# BWD_REL_L2), as tests/test_torch_port_bwd_redesign.py holds the mirror
GATE_MAX, GATE_L2 = 2e-2, 1e-2
GRADS = ("dq", "dkf", "dvf", "dwq2", "dbq2", "dwk2")


# ---- EK_loss -------------------------------------------------------------------

@pytest.mark.parametrize("soft_noun", [False, True])
def test_ek_loss_matches_jax(soft_noun):
    """``ek_loss`` against ``focus_tpu.models.losses.ek_loss`` on the same
    numpy logits of the dual head ([4, 97] verbs, [4, 300] nouns), with
    integer labels and with soft noun labels (float32, rtol 1e-6): the two
    cross-entropies summed, not averaged."""
    from focus_tpu.models import losses as jlosses
    from focus_tpu_torch.models import losses as tlosses

    rs = np.random.RandomState(2)
    verb = rs.randn(4, 97).astype(np.float32)
    noun = rs.randn(4, 300).astype(np.float32)
    labels = {"verb": rs.randint(0, 97, (4,)).astype(np.int32)}
    if soft_noun:
        soft = rs.rand(4, 300).astype(np.float32)
        labels["noun"] = soft / soft.sum(-1, keepdims=True)
    else:
        labels["noun"] = rs.randint(0, 300, (4,)).astype(np.int32)
    want = float(jlosses.ek_loss(
        (jnp.asarray(verb), {"verb": jnp.asarray(verb),
                             "noun": jnp.asarray(noun)}),
        {k: jnp.asarray(v) for k, v in labels.items()}))
    tverb = torch.from_numpy(verb)
    got = tlosses.ek_loss(
        (tverb, {"verb": tverb, "noun": torch.from_numpy(noun)}),
        {k: torch.from_numpy(v) for k, v in labels.items()}).item()
    assert got == pytest.approx(want, rel=1e-6)
    parts = (tlosses.cross_entropy(tverb, torch.from_numpy(labels["verb"]))
             + tlosses.cross_entropy(torch.from_numpy(noun),
                                     torch.from_numpy(labels["noun"])))
    assert got == pytest.approx(parts.item(), rel=1e-6)


def test_ek_loss_dispatch():
    """``get_loss_func`` finds ``EK_loss`` by name and from the HR train
    config, as the JAX package's does."""
    from focus_tpu.models import losses as jlosses
    from focus_tpu_torch.models import losses as tlosses

    assert tlosses.get_loss_func("EK_loss") is tlosses.ek_loss
    assert tlosses.get_loss_func(hr_train_cfg(tiny=True)) is tlosses.ek_loss
    assert jlosses.get_loss_func("EK_loss") is jlosses.ek_loss


# ---- the backward's mirror at N > 256 ----------------------------------------------

BWD_CASES = ["N=257", "N=441", "N=512", "extreme-60 N=441",
             "extreme+50 N=300"]


def _bwd_case(case):
    """(args, dout, scale) in bf16 at F = 2, 2 heads of 64 (C = 128), B =
    1, as the card takes them."""
    N = int(case.split("N=")[1])
    if case.startswith("extreme"):
        sign, mag = (-1.0, 60.0) if case.startswith("extreme-") else (1.0,
                                                                      50.0)
        args, scale = extreme_inputs(sign, mag, F=2, N=N, C=128, heads=HEADS)
    else:
        args = core_inputs(B=1, F=2, N=N, C=128, seed=N)
        scale = 64 ** -0.5
    B, S, C = args[0].shape
    dout = np.random.RandomState(5).randn(B, S, C).astype(np.float32)
    return ([torch.from_numpy(a).bfloat16() for a in args],
            torch.from_numpy(dout).bfloat16(), scale)


@functools.lru_cache(maxsize=None)
def _jax_grads(case):
    """jax.vjp of _xla_reference in float32 on the bf16-rounded inputs."""
    args, dout, scale = _bwd_case(case)

    def grads(args, dout):
        _, vjp = jax.vjp(lambda *a: jtb._xla_reference(*a, scale, HEADS),
                         *args)
        return vjp(dout)

    out = jax.jit(grads)([jnp.asarray(a.float().numpy()) for a in args],
                         jnp.asarray(dout.float().numpy()))
    return [np.asarray(g) for g in out]


def _residuals(args, dout, scale):
    """The forward's xs and q2 from the plain backward, rounded to bf16 as
    the forward kernel keeps them."""
    inter = {}
    ttb.trajectory_core_backward_reference(
        *[a.float() for a in args], dout.float(), scale, HEADS,
        intermediates=inter)
    return inter["xs"].bfloat16(), inter["q2"].bfloat16()


@pytest.mark.parametrize("case", BWD_CASES)
def test_chunked_backward_mirror_meets_the_gate(case):
    """The mirror in the chunked dq kernel's order (r carried online over
    two chunks of ``chunk_keys``; bf16 operands, the kernel's rounding
    points) against jax.vjp of _xla_reference: every gradient within the
    card's gate (max|err| <= 2e-2 x max|ref|, relative L2 <= 1e-2), the
    peaked stage-1 logits included."""
    args, dout, scale = _bwd_case(case)
    xs, q2 = _residuals(args, dout, scale)
    q, kf, vf, wq2, _, wk2, _ = args
    got = ttb.trajectory_core_backward_mirror(q, kf, vf, wq2, wk2, dout, xs,
                                              q2, scale, HEADS)
    assert got[0].dtype == torch.bfloat16 and got[3].dtype == torch.float32
    for name, g, r in zip(GRADS, got, _jax_grads(case)):
        g = g.float().numpy()
        assert np.isfinite(g).all(), name
        emax = float(np.abs(g - r).max() / np.abs(r).max())
        el2 = float(np.linalg.norm(g - r) / np.linalg.norm(r))
        assert emax <= GATE_MAX and el2 <= GATE_L2, (name, case, emax, el2)


@pytest.mark.parametrize("N", [257, 441])
def test_chunked_softmax_and_r_is_the_softmax(N):
    """The chunked sweep's P and r = sum_n P dP equal the softmax's over
    the whole frame in float32 (rtol 1e-5): the online max and the rescale
    of l and r' change the order of the sums, not the function. Chunk 1
    raises the max on some rows and not on others."""
    rs = np.random.RandomState(N)
    logits = torch.from_numpy(rs.randn(3, 5, N).astype(np.float32) * 4)
    dp = torch.from_numpy(rs.randn(3, 5, N).astype(np.float32))
    cw = ttb.chunk_keys(N)
    raised = logits[..., cw:].amax(-1) > logits[..., :cw].amax(-1)
    assert raised.any() and not raised.all()
    p, r = ttb._chunked_softmax_and_r(logits, dp, cw)
    want = torch.softmax(logits, -1)
    torch.testing.assert_close(p, want, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(r, (want * dp).sum(-1), rtol=1e-5, atol=1e-6)


def test_chunked_backward_mirror_matches_pallas_bwd_interpret():
    """In float32 (no rounding point to move), the mirror at N = 260 (two
    chunks of 224: 224 + 36 keys) against the JAX package's backward
    kernel in interpret mode (its keys padded to 384) and jax.vjp of
    _xla_reference, B = 1, F = 2, 2 heads: atol 5e-5 x max|ref| per
    gradient, the Pallas test's padded-shape tolerance relative to the
    gradient's scale."""
    N = 260
    args = core_inputs(B=1, F=2, N=N, C=128, seed=3)
    scale = 64 ** -0.5
    dout = np.random.RandomState(6).randn(1, 2 * N, 128).astype(np.float32)
    jargs = [jnp.asarray(a) for a in args]
    pallas = jtb._fused_bwd_pallas(*jargs[:6], jnp.asarray(dout), scale,
                                   HEADS, block_q=128, interpret=True)
    targs = [torch.from_numpy(a) for a in args]
    inter = {}
    ttb.trajectory_core_backward_reference(*targs, torch.from_numpy(dout),
                                           scale, HEADS, intermediates=inter)
    q, kf, vf, wq2, _, wk2, _ = targs
    got = ttb.trajectory_core_backward_mirror(
        q, kf, vf, wq2, wk2, torch.from_numpy(dout), inter["xs"],
        inter["q2"], scale, HEADS)
    for name, g, r in zip(GRADS, got, pallas):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=5e-5 * float(np.abs(r).max()),
                                   err_msg=name)


# ---- the tiny HR model against the JAX model ----------------------------------------

def ek_batch(cfg, seed):
    """video [2, T, 336, 336, 3], verb and noun labels, boxes."""
    rs = np.random.RandomState(seed)
    T, crop = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    video = rs.rand(2, T, crop, crop, 3).astype(np.float32)
    boxes = (rs.rand(2, T // 2, cfg.ORVIT.O, 4) * 0.5 + 0.25).astype(
        np.float32)
    labels = {"verb": rs.randint(0, 97, (2,)).astype(np.int32),
              "noun": rs.randint(0, 300, (2,)).astype(np.int32)}
    return video, labels, boxes


@pytest.fixture(scope="module")
def tiny_hr():
    """The tiny HR train model (hr_train_cfg(tiny=True): D=24, 3 layers,
    ORViT at [1], the 336 crop in 56-pixel patches, float32) with
    MF.DROP_PATH 0 (the two packages draw their masks from different
    generators), built by the JAX package, its params, and a batch."""
    from focus_tpu.models.build import build_model as jax_build_model
    from focus_tpu.models.build import init_model

    cfg = hr_train_cfg(tiny=True)
    cfg.MF.DROP_PATH = 0.0
    cfg.NUM_GPUS = 1
    jcfg = jax_cfg(cfg)
    video, labels, boxes = ek_batch(cfg, 3)
    jmodel = jax_build_model(jcfg)
    variables = init_model(jmodel, jcfg, (jnp.asarray(video),
                                          {"orvit_bboxes": jnp.asarray(boxes)}),
                           rng=jax.random.PRNGKey(0))
    return {"cfg": cfg, "jcfg": jcfg, "jmodel": jmodel,
            "params": jax.device_get(variables["params"]),
            "batch": (video, labels, boxes)}


def _port_model(tiny_hr):
    model = build_model(tiny_hr["cfg"], device="cpu")
    load_jax_params(model, tiny_hr["params"])
    return model


def test_tiny_hr_loss_and_gradients_match_jax(tiny_hr):
    """Loss and every parameter's gradient (by torch name) against
    jax.value_and_grad of the JAX model's train forward and its ``ek_loss``
    on verb and noun labels. float32; atol 1e-6 on the loss and 2e-5 on the
    gradients, the flagship's (tests/test_torch_port_train.py)."""
    from focus_tpu.models import losses as jlosses
    from focus_tpu_torch.models.losses import ek_loss

    video, labels, boxes = tiny_hr["batch"]
    jmodel = tiny_hr["jmodel"]

    def loss_fn(params):
        preds = jmodel.apply({"params": params}, jnp.asarray(video),
                             {"orvit_bboxes": jnp.asarray(boxes)}, train=True,
                             rngs={"dropout": jax.random.PRNGKey(1)})
        return jlosses.ek_loss(preds, {k: jnp.asarray(v)
                                       for k, v in labels.items()})

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(tiny_hr["params"])
    ref = jax_grads_to_state_dict(jax.device_get(jgrads))
    model = _port_model(tiny_hr)
    preds = model(torch.from_numpy(video),
                  {"orvit_bboxes": torch.from_numpy(boxes)}, train=True)
    assert preds[1]["verb"].shape == (2, 97)
    assert preds[1]["noun"].shape == (2, 300)
    loss = ek_loss(preds, {k: torch.from_numpy(v) for k, v in labels.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-6)
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(ref)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=2e-5,
                                   err_msg=name)


def test_tiny_hr_three_train_steps_match_jax(tiny_hr):
    """Three steps of make_supervised_train_step in both packages from the
    same params and batches, on verb and noun dict labels: the loss of
    every step and every parameter after the third; the stats are the loss
    alone in both (no top-k for EPIC-Kitchens). The yaml's AdamW (base LR
    1e-5, ORViT LR 1e-4, weight decay 5e-2), 2 steps an epoch. float32;
    losses within 1e-5, parameters within 1e-6, where Adam lets an element
    whose gradient is zero but for rounding step by up to the LR: at most 1
    element in 10^4 past 1e-6, none past the sum of the three LRs, as the
    flagship's test allows."""
    from focus_tpu.engine.trainer import _no_wd_paths
    from focus_tpu.engine.trainer import make_supervised_train_step as jmake
    from focus_tpu.models import losses as jlosses
    from focus_tpu.models import optimizer as joptim
    from focus_tpu.parallel import mesh as mesh_lib
    from focus_tpu.parallel.train_state import TrainState
    from focus_tpu_torch.engine.trainer import (
        build_supervised_state,
        make_supervised_train_step,
    )
    from focus_tpu_torch.models.losses import get_loss_func

    cfg, jcfg = tiny_hr["cfg"], tiny_hr["jcfg"]
    spe = 2
    batches = [ek_batch(cfg, seed) for seed in (3, 4, 5)]
    mesh = mesh_lib.build_mesh(jcfg)
    tx = joptim.construct_optimizer(tiny_hr["params"], jcfg, spe,
                                    no_weight_decay_paths=_no_wd_paths(jcfg))
    jstate = TrainState.create(tiny_hr["params"], tx)
    jstep = jmake(tiny_hr["jmodel"], jcfg, mesh, jlosses.get_loss_func(jcfg))

    model = _port_model(tiny_hr)
    state = build_supervised_state(cfg, model, spe)
    step = make_supervised_train_step(model, cfg, get_loss_func(cfg))
    for i, (video, labels, boxes) in enumerate(batches):
        jstate, jstats = jstep(
            jstate, jnp.asarray(video),
            {k: jnp.asarray(v) for k, v in labels.items()},
            {"orvit_bboxes": jnp.asarray(boxes)}, jax.random.PRNGKey(0))
        state, stats = step(
            state, torch.from_numpy(video),
            {k: torch.from_numpy(v).long() for k, v in labels.items()},
            {"orvit_bboxes": torch.from_numpy(boxes)})
        assert state.step == i + 1
        assert set(stats) == set(jstats) == {"loss"}
        np.testing.assert_allclose(stats["loss"].item(),
                                   float(jstats["loss"]), atol=1e-5)
    ref = jax_params_to_state_dict(jax.device_get(jstate.params))
    lr_sum = sum(max(s(k) for s in state.optimizer.schedules)
                 for k in range(3))
    off = total = 0
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - ref[name].numpy())
        off, total = off + int((diff > 1e-6).sum()), total + diff.size
        assert diff.max() <= lr_sum, name
    assert off <= total // 10000


# ---- the entry point ----------------------------------------------------------------

def test_hr_train_entry_on_the_cpu():
    """``hr_train_entry(device="cpu", tiny=True)``: the 336 crop, verb ids
    in [0, 97) and noun ids in [0, 300), drawn after the video and boxes
    from the same RandomState; one step gives a finite loss near ln 97 +
    ln 300 at init scale and no other stat; the config trains under
    EK_loss with the yaml's solver."""
    fn, (video, labels, boxes) = hr_train_entry(device="cpu", batch=3,
                                                tiny=True)
    assert tuple(video.shape) == (3, 4, 336, 336, 3)
    assert tuple(boxes.shape) == (3, 2, 4, 4)
    assert set(labels) == {"verb", "noun"}
    for name, n in (("verb", 97), ("noun", 300)):
        t = labels[name]
        assert t.dtype == torch.int64 and tuple(t.shape) == (3,)
        assert 0 <= int(t.min()) and int(t.max()) < n
    rs = np.random.RandomState(0)
    rs.rand(*video.shape)
    rs.rand(*boxes.shape)
    assert labels["verb"].tolist() == rs.randint(0, 97, (3,)).tolist()
    assert labels["noun"].tolist() == rs.randint(0, 300, (3,)).tolist()
    stats = fn(video, labels, boxes)
    assert set(stats) == {"loss"}
    loss = stats["loss"].item()
    assert np.isfinite(loss)
    assert abs(loss - (np.log(97) + np.log(300))) < 0.5
    assert fn.state.step == 1
    cfg = hr_train_cfg()
    assert cfg.MODEL.LOSS_FUNC == "EK_loss"
    assert cfg.TRAIN.DATASET == "epickitchens"
    s = cfg.SOLVER
    assert (s.OPTIMIZING_METHOD, s.BASE_LR, s.ORVIT_BASE_LR, s.WEIGHT_DECAY,
            s.LR_POLICY, list(s.LRS), list(s.STEPS), s.MAX_EPOCH,
            s.WARMUP_EPOCHS) == ("adamw", 1e-5, 1e-4, 5e-2,
                                 "steps_with_relative_lrs", [1, 0.1, 0.01],
                                 [0, 19, 40], 50, 0.0)
    assert (cfg.MF.DROP_PATH, cfg.MF.EMBED_DIM, cfg.MF.DEPTH,
            cfg.DATA.TRAIN_CROP_SIZE) == (0.2, 768, 12, 336)


# ---- the chunked dq kernel's limits in the CUDA source ------------------------------

def test_backward_source_takes_512_keys_with_the_chunked_dq():
    """``csrc/trajectory_block_bwd.cu``'s entry takes N <= 512 (the
    wrapper's MAX_KEYS_CHUNKED), its padded widths past 256 are two chunks
    of kernel 1's ``chunk_keys``, and the dq dispatch launches the chunked
    form for them."""
    with open(os.path.join(CSRC, "trajectory_block_bwd.cu")) as f:
        src = f.read()
    limit = re.search(r"constexpr int MAX_KEYS = (\d+);", src)
    assert int(limit.group(1)) == ttb.MAX_KEYS_CHUNKED
    assert "N > MAX_KEYS ||" in src and "N > 256" not in src
    assert ": (n <= 448 ? 448 : 512)" in src
    assert "constexpr int dq_chunk_keys(int np) { return np / 2; }" in src
    assert [ttb.chunk_keys(n) for n in (257, 448, 449, 512)] == [
        448 // 2, 448 // 2, 512 // 2, 512 // 2]
    for np_ in (448, 512):
        assert f"err = launch_stage1_dq<{np_}>(" in src
    assert "stage1_dq_chunked_kernel<CH><<<" in src
    assert "static_assert(dqc_stages(224) >= 2 && dqc_stages(256) >= 2" in src
    # the N <= 256 forms keep their dispatch
    for np_ in (64, 128, 208, 256):
        assert f"case {np_}:\n      err = launch_stage1_dq<{np_}>(" in src
