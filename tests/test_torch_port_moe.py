"""The port's Switch-MoE Motionformer against the JAX package on the CPU:
``models/moe.MoEMlp`` against ``focus_tpu.models.moe.MoEMlp`` (ample
capacity, dropped tokens, bf16), the tiny MoE Motionformer's forward and
load-balance value against the JAX model's and its ``_moe_aux``, three
train steps against ``make_supervised_train_step`` (and one under
``TPU.GRAD_ACCUM`` 2), the weight bridge of the stacked expert parameters
(scanned and unscanned), ``TPU.INT8_SERVING`` leaving the experts at the
compute dtype, and the refusal of a world that the ``TPU.MESH`` axes of
both ``configs/TPU`` yamls do not divide. float32 unless stated, one
torch thread a test."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu_torch.config import get_cfg
from focus_tpu_torch.entry import moe_cfg
from focus_tpu_torch.models.build import build_model
from focus_tpu_torch.models.moe import MoEMlp, load_balance
from focus_tpu_torch.utils.weights import (
    jax_params_to_state_dict,
    load_jax_params,
)
from test_torch_port_models import mf_full_cfg
from test_torch_port_train import _jax_labels, jax_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE_ATOL = 2e-5  # tests/test_moe.py's per-token reference
MODEL_ATOL = 2e-5  # test_torch_port_models.py's, on the probabilities


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_moe_aux(new_vars):
    """The JAX trainer's ``_moe_aux``: the weighted mean of the sown
    (aux * w, w) pairs."""
    leaves = jax.tree_util.tree_leaves(new_vars.get("moe", {}))
    num = sum(float(np.sum(np.asarray(leaf)[..., 0])) for leaf in leaves)
    den = sum(float(np.sum(np.asarray(leaf)[..., 1])) for leaf in leaves)
    return num / max(den, 1e-9)


# ---- MoEMlp -----------------------------------------------------------------

def _mlp_pair(capacity_factor, seed=0, b=2, n=9, d=8, h=16, e=3):
    """The JAX MoEMlp's params (biases made non-zero) and the port's
    module on them; x [b, n, d]."""
    from focus_tpu.models.moe import MoEMlp as JaxMoEMlp

    rs = np.random.RandomState(seed)
    x = rs.randn(b, n, d).astype(np.float32)
    jm = JaxMoEMlp(hidden_features=h, num_experts=e,
                   capacity_factor=capacity_factor)
    params = jax.device_get(
        jm.init({"params": jax.random.PRNGKey(seed)}, x)["params"])
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rs.randn(*a.shape).astype(
            np.float32), params)
    port = MoEMlp(d, h, e, capacity_factor)
    load_jax_params(port, params)
    return jm, params, port, x


@pytest.mark.parametrize("case", ["ample", "drops", "bf16"])
def test_moe_mlp_matches_jax(case):
    """ample: capacity E x tokens, no drop, output within 2e-5 and the
    sown load-balance value within 1e-6. drops: capacity factor 1/3 (1
    slot an expert of 9 tokens): every token the JAX layer gives exactly
    zero is exactly zero in the port, and the rest within 2e-5. bf16:
    the same routing (float32 router in both) and the outputs within one
    bf16 rounding (4e-3 relative to the largest)."""
    factor = {"ample": 3.0, "drops": 1 / 3, "bf16": 1.25}[case]
    jm, params, port, x = _mlp_pair(factor)
    dt = (jnp.bfloat16, torch.bfloat16) if case == "bf16" else (
        jnp.float32, torch.float32)
    # eager, as flax runs a module op by op: jit's fusion would skip the
    # bf16 roundings between the einsum, the bias and the GELU
    want, sown = jm.apply({"params": params}, jnp.asarray(x, dt[0]),
                          mutable=["moe"])
    want = np.asarray(want, np.float32)
    with torch.no_grad():
        got, aux = port(torch.from_numpy(x).to(dt[1]))
        probs, idx, gate, pos, cap = port.route(torch.from_numpy(x).to(dt[1]))
    got = got.float().numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    jaux = np.asarray(sown["moe"]["load_balance"])
    assert abs(float(aux) - float(jaux[0])) <= 1e-6 and jaux[1] == 1.0
    if case == "bf16":
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 4e-3 * scale
        return
    np.testing.assert_allclose(got, want, atol=MOE_ATOL)
    dropped = (pos >= cap).numpy()
    if case == "drops":
        assert cap == 1 and dropped.any() and not dropped[:, 0].any()
        assert np.array_equal(np.all(want == 0.0, axis=-1), dropped)
        assert (got[dropped] == 0.0).all()
    else:
        assert not dropped.any()


def test_moe_mlp_gradient_matches_jax():
    """The layer's input and parameter gradients of sum(y * w) + aux
    against jax.grad (capacity 1.25: some tokens dropped), within 2e-5:
    the router's through the gate and the load-balance value."""
    jm, params, port, x = _mlp_pair(1.25, seed=1, n=12)
    w = np.random.RandomState(2).randn(*x.shape).astype(np.float32)

    def loss(p, xx):
        y, sown = jm.apply({"params": p}, xx, mutable=["moe"])
        return jnp.sum(y * w) + sown["moe"]["load_balance"][0]

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = port(xt)
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=MOE_ATOL)
    ref = jax_params_to_state_dict(jax.device_get(gp))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   atol=MOE_ATOL, err_msg=name)
    assert ref["router.weight"].abs().max() > 0


# ---- the tiny MoE Motionformer ---------------------------------------------

def moe_model_cfg(get_cfg_fn, experts, orvit_layers=(), depth=4):
    cfg = mf_full_cfg(get_cfg_fn, orvit_layers, depth)
    cfg.TPU.MOE.NUM_EXPERTS = experts
    return cfg


def jax_params_from_port(jmodel, port_cfg, inputs, seed=0):
    """JAX params for ``jmodel`` holding the port's seeded init of
    ``port_cfg``: the JAX package's importer carries the port's state_dict
    onto the params' ``eval_shape`` (no init compile)."""
    from focus_tpu.utils.torch_import import import_torch_params

    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed)}, *inputs))["params"]
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                      shapes)
    sd = build_model(port_cfg, device="cpu", seed=seed).state_dict()
    params, _ = import_torch_params({k: v.numpy() for k, v in sd.items()},
                                    template, allow_missing=False)
    return params


@functools.lru_cache(maxsize=None)
def _jax_model(experts, orvit_layers, scan=True, seed=0):
    """The JAX tiny MoE Motionformer, its params (the port's seeded init)
    and a batch (built once a case in this process)."""
    from focus_tpu.config import get_cfg as jax_get_cfg
    from focus_tpu.models.build import build_model as jax_build_model

    jcfg = moe_model_cfg(jax_get_cfg, experts, orvit_layers)
    jcfg.TPU.SCAN_LAYERS = scan
    rs = np.random.RandomState(seed)
    video = rs.rand(2, 4, 224, 224, 3).astype(np.float32)
    boxes = (rs.rand(2, 2, 3, 4) * 0.5 + 0.25).astype(np.float32)
    jmodel = jax_build_model(jcfg)
    params = jax_params_from_port(
        jmodel, moe_model_cfg(get_cfg, experts, orvit_layers),
        (jnp.asarray(video), {"orvit_bboxes": jnp.asarray(boxes)}), seed)
    return jmodel, params, video, boxes


@pytest.mark.parametrize("experts,orvit_layers", [
    (2, ()), (4, ()), (2, (1,)), (4, (1,)),
])
def test_tiny_moe_model_matches_jax(experts, orvit_layers):
    """D=24, depth 4, 2 and 4 experts, ORViT off and at block 1 (whose MLP
    stays dense, in both packages): the eval probabilities within 2e-5,
    the train-mode logits within 1e-5 and the mean of the port's per-layer
    load-balance values within 1e-6 of ``_moe_aux`` over the layers JAX
    sows (one a trajectory block)."""
    jmodel, params, video, boxes = _jax_model(experts, orvit_layers)
    meta = {"orvit_bboxes": jnp.asarray(boxes)}
    ref = np.asarray(jax.jit(jmodel.apply)({"params": params},
                                           jnp.asarray(video), meta))
    logits_ref, new_vars = jax.jit(functools.partial(
        jmodel.apply, train=True, mutable=["moe"]))(
        {"params": params}, jnp.asarray(video), meta,
        rngs={"dropout": jax.random.PRNGKey(1)})
    model = build_model(moe_model_cfg(get_cfg, experts, orvit_layers),
                        device="cpu")
    load_jax_params(model, params)
    tmeta = {"orvit_bboxes": torch.from_numpy(boxes)}
    aux = []
    with torch.no_grad():
        out = model(torch.from_numpy(video), tmeta).numpy()
        logits = model(torch.from_numpy(video), tmeta, train=True,
                       moe_aux=aux).numpy()
    np.testing.assert_allclose(out, ref, atol=MODEL_ATOL)
    np.testing.assert_allclose(logits, np.asarray(logits_ref), atol=1e-5)
    moe_blocks = 4 - len(orvit_layers)
    assert len(aux) == moe_blocks
    assert sum(isinstance(b.mlp, MoEMlp) for b in model.blocks) == moe_blocks
    assert abs(float(load_balance(aux)) - jax_moe_aux(new_vars)) <= 1e-6


@pytest.mark.parametrize("scan", [True, False])
def test_weight_bridge_round_trip(scan):
    """JAX params with SCAN_LAYERS on (the trajectory blocks one stacked
    tree, leading layer axis) and off: the bridge gives exactly the port's
    keys and shapes; the router kernel comes across transposed and the
    stacked expert tensors as they are, layer by layer; and the state_dict
    of the port model loaded from them converts back to the same values."""
    _, params, _, _ = _jax_model(4, (), scan=scan)
    assert any(k.startswith("blocks_0_3") for k in params) == scan
    sd = jax_params_to_state_dict(params)
    model = build_model(moe_model_cfg(get_cfg, 4), device="cpu")
    want = model.state_dict()
    assert sorted(sd) == sorted(want)
    assert all(sd[k].shape == want[k].shape for k in want)
    load_jax_params(model, params)
    got = model.state_dict()
    for layer in range(4):
        mlp = (params["blocks_0_3"]["body"]["mlp"] if scan
               else params[f"blocks_{layer}"]["mlp"])
        pick = (lambda a: np.asarray(a)[layer]) if scan else np.asarray
        pre = f"blocks.{layer}.mlp."
        assert np.array_equal(got[pre + "router.weight"].numpy(),
                              pick(mlp["router"]["kernel"]).T)
        for leaf in ("kernel1", "bias1", "kernel2", "bias2"):
            assert np.array_equal(got[pre + "experts." + leaf].numpy(),
                                  pick(mlp["experts"][leaf]))
        assert got[pre + "experts.bias1"].ndim == 2
    assert all(torch.equal(got[k], sd[k]) for k in sd)


def test_int8_serving_leaves_experts_at_the_compute_dtype():
    """With TPU.INT8_SERVING the attention's dense layers go W8A8 and the
    MoE MLPs do not, in both packages: the tiny model's eval probabilities
    within 1e-4 (test_torch_port_int8.py's int8 tolerance, on the log) of
    the JAX model's, and the experts' output unchanged from the model
    without int8 on the same MLP input."""
    from focus_tpu.config import get_cfg as jax_get_cfg
    from focus_tpu.models.build import build_model as jax_build_model

    _, params, video, boxes = _jax_model(2, ())
    jcfg = moe_model_cfg(jax_get_cfg, 2)
    jcfg.TPU.INT8_SERVING = True
    ref = np.asarray(jax.jit(jax_build_model(jcfg).apply)(
        {"params": params}, jnp.asarray(video), {}))
    cfg = moe_model_cfg(get_cfg, 2)
    cfg.TPU.INT8_SERVING = True
    model = build_model(cfg, device="cpu")
    load_jax_params(model, params)
    with torch.no_grad():
        out = model(torch.from_numpy(video)).numpy()
    np.testing.assert_allclose(np.log(out), np.log(ref), atol=1e-4)
    for blk in model.blocks:
        assert blk.attn.int8_dense and isinstance(blk.mlp, MoEMlp)
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 5, 24).astype(
        np.float32))
    plain = build_model(moe_model_cfg(get_cfg, 2), device="cpu")
    load_jax_params(plain, params)
    with torch.no_grad():
        assert torch.equal(model.blocks[0].mlp(x)[0],
                           plain.blocks[0].mlp(x)[0])


# ---- three train steps ----------------------------------------------------

@pytest.fixture(scope="module")
def tiny_moe():
    """``moe_cfg(tiny=True)`` (the MoE yaml at D=24 over 4 blocks, 4
    experts, float32) without drop path, built by the JAX package (the
    port's seeded init as its params)."""
    from focus_tpu.models.build import build_model as jax_build_model

    cfg = moe_cfg(tiny=True)
    cfg.MF.DROP_PATH = 0.0  # the two packages draw their masks apart
    cfg.SOLVER.ZERO_WD_1D_PARAM = True  # the 2-D expert biases decay
    cfg.SOLVER.STEPS, cfg.SOLVER.MAX_EPOCH = [0, 1, 2], 10
    jcfg = jax_cfg(cfg)
    # unscanned: a scanned stack's per-layer 1-D parameters are 2-D leaves
    # to the JAX optimizer, which then decays them (ROADMAP.md section 3)
    jcfg.TPU.SCAN_LAYERS = False
    rs = np.random.RandomState(3)
    video = rs.rand(4, 4, 224, 224, 3).astype(np.float32)
    jmodel = jax_build_model(jcfg)
    params = jax_params_from_port(jmodel, cfg, (jnp.asarray(video), {}))
    return {"cfg": cfg, "jcfg": jcfg, "jmodel": jmodel, "params": params}


def _batches(cfg, n, batch):
    rs = np.random.RandomState(5)
    T, crop = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    return [(rs.rand(batch, T, crop, crop, 3).astype(np.float32),
             rs.randint(0, cfg.MODEL.NUM_CLASSES, (batch,)).astype(np.int32))
            for _ in range(n)]


@pytest.mark.parametrize("accum", [1, 2])
def test_three_moe_train_steps_match_jax(tiny_moe, accum):
    """Three steps of make_supervised_train_step in both packages from the
    same params and batches (AdamW, the yaml's label-smoothing loss, 2
    steps an epoch so the LR moves inside them, AUX_LOSS_WEIGHT 0.01;
    accum 2: two strided microbatches of 2, one aux each): every step's
    loss within 1e-5 and moe_aux within 1e-6, then every parameter as
    test_torch_port_train.py holds them (1e-6, with at most 1 element in
    10^4 of the model past it, by less than the sum of the LRs). Every
    parameter falls in JAX's optimizer group: the expert biases are 2-D,
    so both packages give them weight decay under ZERO_WD_1D_PARAM."""
    from focus_tpu.engine.trainer import _no_wd_paths
    from focus_tpu.engine.trainer import make_supervised_train_step as jmake
    from focus_tpu.models import losses as jlosses
    from focus_tpu.models import optimizer as joptim
    from focus_tpu.parallel import mesh as mesh_lib
    from focus_tpu.parallel.train_state import TrainState
    from focus_tpu_torch.engine.trainer import (
        build_supervised_state,
        make_supervised_train_step,
        no_wd_paths,
    )
    from focus_tpu_torch.models.losses import get_loss_func
    from focus_tpu_torch.models.optimizer import param_label

    cfg = tiny_moe["cfg"].clone()
    cfg.TPU.GRAD_ACCUM = accum
    assert cfg.TPU.MOE.AUX_LOSS_WEIGHT == 0.01
    jcfg = tiny_moe["jcfg"].clone()
    jcfg.TPU.GRAD_ACCUM = accum
    spe = 2
    mesh = mesh_lib.build_mesh(jcfg)
    tx = joptim.construct_optimizer(tiny_moe["params"], jcfg, spe,
                                    no_weight_decay_paths=_no_wd_paths(jcfg))
    # placed as the step places its output state, so that the later steps
    # reuse the first one's compile
    jstate = jax.device_put(TrainState.create(tiny_moe["params"], tx),
                            mesh_lib.replicated(mesh))
    jstep = jmake(tiny_moe["jmodel"], jcfg, mesh, jlosses.get_loss_func(jcfg))

    model = build_model(cfg, device="cpu")
    load_jax_params(model, tiny_moe["params"])
    labels = {n: param_label(n, p.ndim, cfg, no_wd_paths(cfg))
              for n, p in model.named_parameters()}
    assert labels == _jax_labels(tiny_moe["params"], jcfg, spe,
                                 no_wd_paths(cfg))
    assert labels["blocks.0.mlp.experts.bias1"] == "main"
    assert labels["blocks.0.mlp.router.bias"] == "zero"
    state = build_supervised_state(cfg, model, spe)
    step = make_supervised_train_step(model, cfg, get_loss_func(cfg))
    for video, labels in _batches(cfg, 3, 4):
        jstate, jstats = jstep(jstate, jnp.asarray(video), jnp.asarray(labels),
                               {}, jax.random.PRNGKey(0))
        state, stats = step(state, torch.from_numpy(video),
                            torch.from_numpy(labels).long(), {})
        np.testing.assert_allclose(stats["loss"].item(),
                                   float(jstats["loss"]), atol=1e-5)
        np.testing.assert_allclose(stats["moe_aux"].item(),
                                   float(jstats["moe_aux"]), atol=1e-6)
    ref = jax_params_to_state_dict(jax.device_get(jstate.params))
    lr_sum = sum(state.optimizer.schedules[0](k) for k in range(3))
    off = total = 0
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - ref[name].numpy())
        off, total = off + int((diff > 1e-6).sum()), total + diff.size
        assert diff.max() <= lr_sum, name
    assert off <= total // 10000


# ---- the mesh -----------------------------------------------------------------

@pytest.mark.parametrize("yaml", ["SSv2_MF_224_16x4_pp_moe.yaml",
                                  "SSv2_ORViT-MF_224_16x4_dp_sp_tp.yaml"])
def test_mesh_axes_raise_before_anything_is_built(yaml, tmp_path):
    """Both configs/TPU yamls as shipped raise from the model builder, the
    train step and the test path, on one process on the CPU, before any
    module or loader exists: the JAX package's refusal of a world that the
    axes do not divide (ValueError; the MoE yaml's PIPE 2 and EXPERT 2, the
    dp x sp x tp yaml's SEQ 2 and MODEL 2). With every axis set to 1 the
    MoE yaml's tiny model builds."""
    from focus_tpu_torch.engine import tester
    from focus_tpu_torch.engine.trainer import (
        make_supervised_train_step,
        run_train,
    )
    from focus_tpu_torch.models.losses import get_loss_func

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "TPU", yaml))
    cfg.OUTPUT_DIR = str(tmp_path)
    axes = [k for k in ("PIPE", "SEQ", "MODEL", "EXPERT")
            if cfg.TPU.MESH[k] > 1]
    assert len(axes) == 2
    for call in (lambda: build_model(cfg, device="cpu"),
                 lambda: make_supervised_train_step(None, cfg,
                                                    get_loss_func(cfg)),
                 lambda: run_train(cfg, device="cpu"),
                 lambda: tester.run_test(cfg, device="cpu")):
        if "moe" in yaml:
            match = ("1 devices not divisible by model axis 1 x seq axis 1 "
                     "x pipe axis 2 x expert axis 2")
        else:
            match = "1 devices not divisible by model axis 2 x seq axis 2"
        with pytest.raises(ValueError, match=match):
            call()
    assert not os.listdir(tmp_path)
    if "moe" in yaml:
        model = build_model(moe_cfg(tiny=True), device="cpu")
        assert sum(isinstance(b.mlp, MoEMlp) for b in model.blocks) == 4
