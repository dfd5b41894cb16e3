"""The port's training slice on the CPU against the JAX package on the same
numpy inputs: the trajectory-core backward, the patch-embed backward, the
tiny flagship's loss and gradients, three train steps in two optimizer
set-ups, the LR schedule, the group labels and stochastic depth."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from focus_tpu.ops.pallas import trajectory_block as jtb
from focus_tpu.ops.pallas.patch_embed import patch_embed_3d as jax_patch_embed
from focus_tpu_torch.entry import train_cfg
from focus_tpu_torch.models.build import build_model
from focus_tpu_torch.models.motionformer import DropPath, drop_path
from focus_tpu_torch.models.optimizer import epoch_lr_schedule, param_label
from focus_tpu_torch.ops import patch_embed as tpe
from focus_tpu_torch.ops import trajectory_block as ttb
from focus_tpu_torch.utils.weights import (
    jax_grads_to_state_dict,
    jax_params_to_state_dict,
    load_jax_params,
)

from tests.test_torch_port_kernels import core_inputs, extreme_inputs

HEADS = 4


# ---- trajectory-core backward --------------------------------------------

def _core_case(case):
    if case.startswith("extreme"):
        sign, mag = {"extreme-25": (-1.0, 25.0), "extreme-60": (-1.0, 60.0),
                     "extreme+50": (1.0, 50.0)}[case]
        args, scale = extreme_inputs(sign, mag)
    else:
        args = core_inputs(N=int(case.split("N=")[1]), seed=1)
        scale = (16 // HEADS) ** -0.5
    B, S, C = args[0].shape
    dout = np.random.RandomState(5).randn(B, S, C).astype(np.float32)
    return args, dout, scale


@functools.lru_cache(maxsize=None)
def _jax_core_grads(case):
    args, dout, scale = _core_case(case)

    def grads(args, dout):
        _, vjp = jax.vjp(lambda *a: jtb._xla_reference(*a, scale, HEADS),
                         *args)
        return vjp(dout)

    out = jax.jit(grads)([jnp.asarray(a) for a in args], jnp.asarray(dout))
    return [np.asarray(g) for g in out]


@pytest.mark.parametrize("case", ["N=12", "N=13", "extreme-25", "extreme-60",
                                  "extreme+50"])
@pytest.mark.parametrize("path", ["backward_reference", "autograd"])
def test_trajectory_core_backward_matches_jax_vjp(case, path):
    """Both plain backwards against jax.vjp of _xla_reference, at the JAX
    test's tolerance (tests/test_fused_block.py:49, atol 1e-4), including
    the peaked stage-1 logits of _extreme_inputs."""
    args, dout, scale = _core_case(case)
    ref = _jax_core_grads(case)
    targs = [torch.from_numpy(a) for a in args]
    if path == "backward_reference":
        got = ttb.trajectory_core_backward_reference(
            *targs, torch.from_numpy(dout), scale, HEADS)
    else:
        for t in targs:
            t.requires_grad_(True)
        out = ttb.fused_trajectory_core(*targs, scale, HEADS)
        out.backward(torch.from_numpy(dout))
        got = [t.grad if t.grad is not None else torch.zeros_like(t)
               for t in targs]
    for name, g, r in zip(("dq", "dkf", "dvf", "dwq2", "dbq2", "dwk2",
                           "dbk2"), got, ref):
        g = g.detach().numpy()
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, atol=1e-4, err_msg=name)


def test_trajectory_core_backward_reference_intermediates():
    """The reference's recomputed xs and q2 are the plain forward's."""
    args, dout, scale = _core_case("N=12")
    targs = [torch.from_numpy(a) for a in args]
    inter = {}
    ttb.trajectory_core_backward_reference(*targs, torch.from_numpy(dout),
                                           scale, HEADS, intermediates=inter)
    assert set(inter) == {"xs", "q2", "dq2", "dxs"}
    B, S, C = targs[0].shape
    F = targs[1].shape[1]
    assert inter["dxs"].shape == (B, S, F, C)
    q2 = inter["q2"].reshape(B, S, HEADS, C // HEADS)
    out = torch.einsum(
        "bshf,bsfhd->bshd",
        torch.softmax(torch.einsum(
            "bshd,chd,bsfc->bshf", q2, targs[5].reshape(C, HEADS, -1),
            inter["xs"]) * scale, -1),
        inter["xs"].reshape(B, S, F, HEADS, -1)).reshape(B, S, C)
    np.testing.assert_allclose(
        out.numpy(), ttb.trajectory_core_reference(*targs, scale, HEADS).numpy(),
        atol=1e-6)


# ---- patch-embed backward ------------------------------------------------

@pytest.mark.parametrize("shape,kernel", [
    ((2, 4, 64, 64, 3), (2, 16, 16)),
    ((1, 3, 32, 48, 3), (1, 16, 16)),
    ((2, 2, 32, 32, 8), (2, 16, 16)),
])
def test_patch_embed_backward_matches_jax_vjp(shape, kernel):
    """The autograd Function on the CPU against jax.vjp of the Pallas patch
    embed in interpret mode (float32; atol 2e-5, the forward test's)."""
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32)
    kt, kh, kw = kernel
    C, dim = shape[-1], 24
    w = (rs.randn(kt, kh, kw, C, dim) * 0.05).astype(np.float32)
    b = (rs.randn(dim) * 0.1).astype(np.float32)
    tokens, vjp = jax.vjp(
        lambda *a: jax_patch_embed(*a, kernel, interpret=True)[0],
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    dout = rs.randn(*tokens.shape).astype(np.float32)
    dx_ref, dw_ref, db_ref = vjp(jnp.asarray(dout))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    out, _ = tpe.patch_embed_3d(tx, tw, tb, kernel)
    out.backward(torch.from_numpy(dout))
    for name, got, ref in (("dx", tx.grad, dx_ref), ("dw", tw.grad, dw_ref),
                           ("db", tb.grad, db_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                                   err_msg=name)
    # without a video gradient only the weight and bias get one
    tw.grad = None
    out, _ = tpe.patch_embed_3d(torch.from_numpy(x), tw, tb, kernel)
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw_ref), atol=2e-5)


# ---- the tiny flagship against the JAX model -----------------------------

def jax_cfg(port_cfg):
    """The JAX package's config with every value of ``port_cfg`` (the
    port's config tree is a copy of it)."""
    from focus_tpu.config import get_cfg as jax_get_cfg

    def copy(src, dst):
        for k, v in src.items():
            if isinstance(v, dict):
                copy(v, dst[k])
            else:
                dst[k] = v

    cfg = jax_get_cfg()
    copy(port_cfg, cfg)
    return cfg


def tiny_batch(cfg, seed=3):
    rs = np.random.RandomState(seed)
    T, crop = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    video = rs.rand(2, T, crop, crop, 3).astype(np.float32)
    boxes = (rs.rand(2, T // 2, cfg.ORVIT.O, 4) * 0.5 + 0.25).astype(np.float32)
    labels = rs.randint(0, cfg.MODEL.NUM_CLASSES, (2,)).astype(np.int32)
    return video, labels, boxes


@pytest.fixture(scope="module")
def tiny():
    """The tiny flagship (train_cfg(tiny=True): D=24, 3 layers, ORViT at
    [1], float32) built by the JAX package, its params, and a batch."""
    from focus_tpu.models.build import build_model as jax_build_model
    from focus_tpu.models.build import init_model

    cfg = train_cfg(tiny=True)
    cfg.NUM_GPUS = 1
    jcfg = jax_cfg(cfg)
    video, labels, boxes = tiny_batch(cfg)
    jmodel = jax_build_model(jcfg)
    variables = init_model(jmodel, jcfg, (jnp.asarray(video),
                                          {"orvit_bboxes": jnp.asarray(boxes)}),
                           rng=jax.random.PRNGKey(0))
    return {"cfg": cfg, "jcfg": jcfg, "jmodel": jmodel,
            "params": jax.device_get(variables["params"]),
            "batch": (video, labels, boxes)}


def port_model(tiny, cfg=None):
    model = build_model(cfg or tiny["cfg"], device="cpu")
    load_jax_params(model, tiny["params"])
    return model


def test_model_loss_and_gradients_match_jax(tiny):
    """Loss and every parameter's gradient (by torch name) against
    jax.value_and_grad of the JAX model's train forward and the
    label-smoothing loss. float32; atol 1e-6 on the loss and 2e-5 on the
    gradients (measured <= 2e-7 and <= 3e-7: sums in another order)."""
    from focus_tpu.models import losses as jlosses

    video, labels, boxes = tiny["batch"]
    jmodel = tiny["jmodel"]

    def loss_fn(params):
        logits = jmodel.apply({"params": params}, jnp.asarray(video),
                              {"orvit_bboxes": jnp.asarray(boxes)}, train=True,
                              rngs={"dropout": jax.random.PRNGKey(1)})
        return jlosses.label_smoothing_cross_entropy(logits,
                                                     jnp.asarray(labels))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(tiny["params"])
    ref = jax_grads_to_state_dict(jax.device_get(jgrads))

    from focus_tpu_torch.models.losses import label_smoothing_cross_entropy

    model = port_model(tiny)
    logits = model(torch.from_numpy(video),
                   {"orvit_bboxes": torch.from_numpy(boxes)}, train=True)
    assert logits.dtype == torch.float32 and logits.shape == (2, 174)
    loss = label_smoothing_cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-6)
    # a parameter the plain graph never reads (proj_kv's bias: its k half
    # drops out of the stage-2 softmax, its v half is unused with
    # use_original_code) has no gradient, where JAX's is zero
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(ref)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=2e-5,
                                   err_msg=name)
    C = model.embed_dim
    for blk in ("blocks.0", "blocks.1", "blocks.2"):
        assert not ref[f"{blk}.attn.proj_kv.weight"][C:].any()
        assert not ref[f"{blk}.attn.proj_kv.bias"].any()


def _jax_labels(params, jcfg, steps_per_epoch, no_wd):
    """JAX's group of every param, read off the multi_transform state: a
    group's Adam moments hold a MaskedNode where a param is not in it."""
    from focus_tpu.models import optimizer as joptim

    tx = joptim.construct_optimizer(params, jcfg, steps_per_epoch,
                                    no_weight_decay_paths=no_wd)
    state = tx.init(params)
    while not hasattr(state, "inner_states"):
        state = state[-1]
    labels = {}
    for label, inner in state.inner_states.items():
        mu = next(s.mu for s in jax.tree_util.tree_leaves(
            inner.inner_state, is_leaf=lambda s: hasattr(s, "mu")))
        present = jax.tree_util.tree_map(
            lambda leaf: not isinstance(leaf, optax.MaskedNode), mu,
            is_leaf=lambda leaf: isinstance(leaf, optax.MaskedNode))
        for name, flag in jax_params_to_state_dict(present).items():
            if bool(flag.item() if flag.numel() == 1 else flag.all()):
                labels[name] = label
    return labels


@pytest.mark.parametrize("zero_wd_1d,orvit_lr", [(True, 1e-3), (False, -1.0)])
def test_param_labels_match_jax(tiny, zero_wd_1d, orvit_lr):
    """Every parameter's group from the port's rule on its torch name equals
    the JAX package's label of the same parameter. The Motionformer names
    no module "orvit" (its ORViT blocks are blocks_i), so the orvit groups
    hold nothing in either package; an MViT-style name does reach them."""
    from focus_tpu_torch.engine.trainer import no_wd_paths

    cfg = tiny["cfg"].clone()
    cfg.SOLVER.OPTIMIZING_METHOD = "adam"
    cfg.SOLVER.ZERO_WD_1D_PARAM = zero_wd_1d
    cfg.SOLVER.ORVIT_BASE_LR = orvit_lr
    want = _jax_labels(tiny["params"], jax_cfg(cfg), 10, no_wd_paths(cfg))
    model = port_model(tiny, cfg)
    got = {n: param_label(n, p.ndim, cfg, no_wd_paths(cfg))
           for n, p in model.named_parameters()}
    assert got == want
    assert param_label("orvit_blocks.0.attn.qkv.weight", 2, cfg) == (
        "orvit_main" if orvit_lr > 0 else "main")


def _optimizer_cfg(tiny, case):
    cfg = tiny["cfg"].clone()
    s = cfg.SOLVER
    if case == "adamw_groups_steps":
        s.OPTIMIZING_METHOD = "adamw"
        s.BASE_LR, s.ORVIT_BASE_LR, s.WEIGHT_DECAY = 2e-3, 1e-3, 0.5
        s.ZERO_WD_1D_PARAM = True
        s.LR_POLICY = "steps_with_relative_lrs"
        s.LRS, s.STEPS, s.MAX_EPOCH = [1, 0.5, 0.25], [0, 1, 2], 10
    else:  # nesterov sgd, global-norm clip, linear warmup into cosine
        s.OPTIMIZING_METHOD = "sgd"
        s.MOMENTUM, s.NESTEROV = 0.9, True
        s.BASE_LR, s.WEIGHT_DECAY = 0.5, 1e-3
        s.LR_POLICY, s.MAX_EPOCH = "cosine", 4
        s.WARMUP_EPOCHS, s.WARMUP_START_LR = 1.0, 0.05
        s.CLIP_GRAD_L2NORM = 0.05
    return cfg


@pytest.mark.parametrize("case", ["adamw_groups_steps", "sgd_clip_warmup"])
def test_three_train_steps_match_jax(tiny, case):
    """Three steps of make_supervised_train_step in both packages from the
    same params and batches: the loss of every step, then every parameter
    and the top-k errors after the third. 2 steps per epoch, so the LR
    changes inside the three steps. float32; losses within 1e-5, parameters
    within 1e-6. Adam divides each gradient element by its own magnitude,
    so an element whose gradient is zero but for rounding (the k biases,
    whose exact gradient vanishes in the softmax) can step by up to the LR
    differently: under AdamW at most 1 element in 10^4 of the model may
    exceed 1e-6 (measured 11 of ~1.1M), and none the sum of the three
    LRs."""
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

    cfg = _optimizer_cfg(tiny, case)
    jcfg = jax_cfg(cfg)
    spe = 2
    batches = [tiny_batch(cfg, seed) for seed in (3, 4, 5)]
    mesh = mesh_lib.build_mesh(jcfg)
    # build_supervised_state without its init: the params are the fixture's
    tx = joptim.construct_optimizer(tiny["params"], jcfg, spe,
                                    no_weight_decay_paths=_no_wd_paths(jcfg))
    # placed as the step places its output state, so that the later steps
    # reuse the first one's compile
    jstate = jax.device_put(TrainState.create(tiny["params"], tx),
                            mesh_lib.replicated(mesh))
    jstep = jmake(tiny["jmodel"], jcfg, mesh, jlosses.get_loss_func(jcfg))

    model = port_model(tiny, cfg)
    state = build_supervised_state(cfg, model, spe)
    step = make_supervised_train_step(model, cfg, get_loss_func(cfg))
    for i, (video, labels, boxes) in enumerate(batches):
        jstate, jstats = jstep(jstate, jnp.asarray(video), jnp.asarray(labels),
                               {"orvit_bboxes": jnp.asarray(boxes)},
                               jax.random.PRNGKey(0))
        state, stats = step(state, torch.from_numpy(video),
                            torch.from_numpy(labels).long(),
                            {"orvit_bboxes": torch.from_numpy(boxes)})
        assert state.step == i + 1
        np.testing.assert_allclose(stats["loss"].item(),
                                   float(jstats["loss"]), atol=1e-5)
    for k in ("top1_err", "top5_err"):
        assert stats[k].item() == pytest.approx(float(jstats[k]))
    ref = jax_params_to_state_dict(jax.device_get(jstate.params))
    init = jax_params_to_state_dict(tiny["params"])
    lr_sum = sum(state.optimizer.schedules[0](k) for k in range(3))
    off = total = 0
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - ref[name].numpy())
        off, total = off + int((diff > 1e-6).sum()), total + diff.size
        assert diff.max() <= (lr_sum if case.startswith("adamw") else 1e-6), name
        # a parameter moves in the port exactly where it moves in JAX
        assert np.array_equal(ref[name].numpy() != init[name].numpy(),
                              p.detach().numpy() != init[name].numpy()) or (
            diff.max() <= 1e-6), name
    assert off <= total // 10000


# ---- schedule, stochastic depth ------------------------------------------

@pytest.mark.parametrize("policy,warmup", [("cosine", 0.0), ("cosine", 1.5),
                                           ("steps_with_relative_lrs", 0.0),
                                           ("steps_with_relative_lrs", 1.5)])
@pytest.mark.parametrize("which", ["lr", "orvit_lr"])
def test_lr_schedule_matches_jax(policy, warmup, which):
    from focus_tpu.models.optimizer import _epoch_lr_schedule

    cfg = train_cfg(tiny=True)
    s = cfg.SOLVER
    s.LR_POLICY, s.WARMUP_EPOCHS, s.WARMUP_START_LR = policy, warmup, 1e-6
    s.BASE_LR, s.ORVIT_BASE_LR, s.COSINE_END_LR = 1e-3, 3e-4, 1e-6
    s.MAX_EPOCH, s.STEPS, s.LRS = 8, [0, 2, 5], [1, 0.1, 0.01]
    want = _epoch_lr_schedule(jax_cfg(cfg), 10, which)
    got = epoch_lr_schedule(cfg, 10, which)
    for step in (0, 1, 9, 10, 14, 15, 16, 20, 49, 50, 51, 79, 80, 100):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-5,
                                          abs=1e-12), step


def test_drop_path_semantics():
    """A mask per sample; a kept sample is scaled by 1 / keep; rate 0 or
    eval is the identity; the generator fixes the mask."""
    x = torch.randn(64, 5, 3)
    g = torch.Generator().manual_seed(0)
    y = drop_path(x, 0.25, g)
    kept = (y != 0).flatten(1)
    assert (kept.all(1) | ~kept.any(1)).all()  # whole samples kept or not
    assert 0 < kept.all(1).sum() < 64
    torch.testing.assert_close(y[kept.all(1)], x[kept.all(1)] / 0.75)
    torch.testing.assert_close(
        drop_path(x, 0.25, torch.Generator().manual_seed(0)), y)
    gen = torch.Generator().manual_seed(0)
    assert DropPath(0.0)(x, train=True, generator=gen) is x
    assert DropPath(0.3)(x, train=False, generator=gen) is x
    # the keep rate over many samples
    big = drop_path(torch.ones(20000, 1), 0.25,
                    torch.Generator().manual_seed(1))
    assert abs((big != 0).float().mean().item() - 0.75) < 0.02


def test_drop_path_rates_follow_jax(tiny):
    """The trajectory blocks' rates are the JAX linspace to MF.DROP_PATH;
    the ORViT block's stays 0, as the JAX model builds it."""
    cfg = tiny["cfg"].clone()
    cfg.MF.DROP_PATH = 0.2
    model = build_model(cfg, device="cpu")
    rates = [blk.drop_path.drop_prob for blk in model.blocks]
    np.testing.assert_allclose(rates, [0.0, 0.0, 0.2])


# ---- losses, input normalisation, zero init ------------------------------

@pytest.mark.parametrize("name,soft", [
    ("cross_entropy", False), ("cross_entropy", True), ("bce", True),
    ("bce_logit", True), ("soft_cross_entropy", True),
    ("label_smoothing_cross_entropy", False),
    ("label_smoothing_cross_entropy", True),
])
def test_losses_match_jax(name, soft):
    """Each loss against the JAX package's on the same numpy logits and
    labels (float32, rtol 1e-6)."""
    from focus_tpu.models import losses as jlosses
    from focus_tpu_torch.models import losses as tlosses

    rs = np.random.RandomState(0)
    logits = rs.randn(4, 7).astype(np.float32)
    if name == "bce":
        logits = 1.0 / (1.0 + np.exp(-logits))  # probabilities
    if soft:
        labels = rs.rand(4, 7).astype(np.float32)
        if name not in ("bce", "bce_logit"):
            labels /= labels.sum(-1, keepdims=True)
    else:
        labels = rs.randint(0, 7, (4,)).astype(np.int32)
    want = float(jlosses.get_loss_func(name)(jnp.asarray(logits),
                                             jnp.asarray(labels)))
    got = tlosses.get_loss_func(name)(torch.from_numpy(logits),
                                      torch.from_numpy(labels)).item()
    assert got == pytest.approx(want, rel=1e-6)


def test_device_normalize_matches_jax():
    from focus_tpu.ops.preprocess import device_normalize as jnorm
    from focus_tpu_torch.ops.preprocess import device_normalize

    cfg = train_cfg(tiny=True)
    cfg.DATA.MEAN, cfg.DATA.STD = [0.5, 0.4, 0.3], [0.2, 0.25, 0.3]
    raw = np.random.RandomState(0).randint(0, 256, (2, 3, 4, 4, 3)).astype(
        np.uint8)
    want = np.asarray(jnorm(jnp.asarray(raw), jax_cfg(cfg)))
    got = device_normalize(torch.from_numpy(raw), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    x = torch.rand(2, 3)
    assert device_normalize(x, cfg) is x
    pair = device_normalize((torch.from_numpy(raw), x), cfg)
    assert pair[1] is x and pair[0].dtype == torch.float32


def test_zero_init_orvit_matches_jax():
    """ORVIT.ZERO_INIT_ORVIT zeroes the residually added ORViT blocks only
    (names ``orvit_blocks_*``; the Motionformer has none)."""
    from focus_tpu.models.build import maybe_zero_init_orvit as jzero
    from focus_tpu_torch.models.build import maybe_zero_init_orvit

    cfg = train_cfg(tiny=True)
    cfg.ORVIT.ZERO_INIT_ORVIT = True
    model = torch.nn.Module()
    model.blocks = torch.nn.ModuleList([torch.nn.Linear(3, 3)])
    model.orvit_blocks = torch.nn.ModuleList([torch.nn.Linear(3, 3)])
    params = {"blocks_0": {"kernel": np.ones((3, 3), np.float32)},
              "orvit_blocks_0": {"kernel": np.ones((3, 3), np.float32)}}
    want = jzero(jax_cfg(cfg), params)
    kept = model.blocks[0].weight.clone()
    maybe_zero_init_orvit(cfg, model)
    assert not model.orvit_blocks[0].weight.any()
    assert torch.equal(model.blocks[0].weight, kept)
    assert not np.asarray(want["orvit_blocks_0"]["kernel"]).any()
    assert np.asarray(want["blocks_0"]["kernel"]).all()
    flagship = build_model(cfg, device="cpu")
    before = {n: p.clone() for n, p in flagship.named_parameters()}
    maybe_zero_init_orvit(cfg, flagship)
    assert all(torch.equal(before[n], p) for n, p in flagship.named_parameters())
