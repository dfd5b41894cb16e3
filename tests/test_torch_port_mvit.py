"""The port's MViT (``focus_tpu_torch/models/mvit.py``) against the
reference's golden fixtures and ``focus_tpu.models.mvit`` on the CPU, at
small widths (D=24 over 4 blocks, 4 frames, the 64 crop, as
``tests/test_full_model_golden.py::test_mvit_full_golden``), float32.

Tolerances: ``mvit_full.npz`` 1e-4 and ``multiscale_attention.npz`` 3e-5
(the JAX tests' own); ``MultiScaleAttention`` against JAX's 1e-5; the
model's eval probabilities 1e-5; its train-mode logits and every gradient
1e-4 of the tensor's largest value (of the model's largest gradient for
the keys' LayerNorm bias, whose gradient is zero in exact arithmetic: it
adds one constant to each query's logits, which the softmax removes).
The W8A8 forward (``TPU.INT8_SERVING``): each of its W8A8 dense layers on
the activations the port's forward gives it against JAX's
``quantized_dense`` on the same ones, 1e-5; the probabilities against JAX's
W8A8 forward 5e-3. The two forwards' float32 activations differ in their
last bits, so a few activation codes round the other way (each a quantum
of its row, 0.01-0.05 in a block's output here); measured 1.5-2.3e-3 of
probability over three seeds, against 2.6-5.4e-3 between JAX's W8A8 and
float forwards.

JAX's parameters are drawn once from numpy over the shapes of
``jax.eval_shape`` of its init (no init compile), LayerNorm scales
randomised so that an unmapped name shows, then carried to the port by
``utils/weights.load_jax_params``."""

import glob
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu_torch.config import get_cfg
from focus_tpu_torch.models import mvit as tmvit
from focus_tpu_torch.models.build import (
    MODEL_REGISTRY,
    build_model,
    init_weights,
    maybe_zero_init_orvit,
)
from focus_tpu_torch.utils.weights import (
    jax_grads_to_state_dict,
    jax_params_to_state_dict,
    load_jax_params,
)
from torch_port_trees import jax_cfg_like

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
FIXTURE_ATOL = 1e-4
ATTN_FIXTURE_ATOL = 3e-5
ATTN_ATOL = 1e-5
PROB_ATOL = 1e-5
TRAIN_RTOL = 1e-4
INT8_LAYER_ATOL = 1e-5
INT8_ATOL = 5e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These models are small: one intra-op thread runs them as fast as
    many, and beside the other test workers many spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_fixture(name):
    data = dict(np.load(os.path.join(FIXDIR, f"{name}.npz")))
    sd = {k[3:]: torch.from_numpy(v) for k, v in data.items()
          if k.startswith("sd/")}
    return data, sd


def mvit_cfg(**changes):
    """``test_mvit_full_golden``'s config (4 blocks, widths and heads
    doubled at block 1, where the queries are strided), float32, with
    ``changes`` ("MVIT.SEP_POS_EMBED": True, ...)."""
    cfg = get_cfg()
    cfg.MODEL.MODEL_NAME, cfg.MODEL.ARCH = "MViT", "mvit"
    cfg.MODEL.NUM_CLASSES = 7
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 64
    cfg.MVIT.EMBED_DIM, cfg.MVIT.NUM_HEADS, cfg.MVIT.DEPTH = 24, 2, 4
    cfg.MVIT.DIM_MUL = cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MVIT.POOL_Q_STRIDE = [[1, 1, 2, 2]]
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
    cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 4, 4]
    cfg.MVIT.PATCH_PADDING = [1, 3, 3]
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.TPU.COMPUTE_DTYPE = "float32"
    for key, value in changes.items():
        node, leaf = key.rsplit(".", 1)
        sub = cfg
        for part in node.split("."):
            sub = sub[part]
        sub[leaf] = value
    return cfg


def draw_like(shapes, seed=0):
    """Numpy draws over a tree of shapes: kernels N(0, 1 / fan_in), scales
    1 + N(0, 0.2^2), the rest (biases, embeddings, box categories)
    N(0, 0.1^2); float32."""
    rs = np.random.RandomState(seed)

    def draw(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        if leaf == "kernel":
            v = rs.randn(*s.shape) / math.sqrt(math.prod(s.shape[:-1]))
        elif leaf == "scale":
            v = 1.0 + 0.2 * rs.randn(*s.shape)
        else:
            v = 0.1 * rs.randn(*s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_pair(cfg, *args, seed=0):
    """(JAX module, its random params, the port's model with them) for
    ``cfg``; ``args`` are the JAX call's inputs after the clip."""
    from focus_tpu.models.build import build_model as jax_build_model

    jmodel = jax_build_model(jax_cfg_like(cfg))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *args, train=False))
    params = draw_like(shapes["params"], seed)
    model = build_model(cfg, device="cpu")
    load_jax_params(model, params)
    return jmodel, params, model


def clip(cfg, batch=2, seed=3):
    crop = cfg.DATA.TRAIN_CROP_SIZE
    return np.random.RandomState(seed).randn(
        batch, cfg.DATA.NUM_FRAMES, crop, crop, 3).astype(np.float32)


def orvit_boxes(cfg, batch=2, seed=5):
    """Normalised cxcywh boxes [B, T, O, 4] inside the frame."""
    rs = np.random.RandomState(seed)
    shape = (batch, cfg.DATA.NUM_FRAMES, cfg.ORVIT.O)
    centre = rs.uniform(0.3, 0.7, shape + (2,))
    size = rs.uniform(0.1, 0.4, shape + (2,))
    return np.concatenate([centre, size], -1).astype(np.float32)


def t2n(t):
    return t.detach().float().numpy()


# ---- the golden fixtures ----------------------------------------------------

def test_mvit_full_fixture():
    """The executed reference's MViT state dict loads every name of the
    port's model, none unused; its eval probabilities within 1e-4."""
    data, sd = load_fixture("mvit_full")
    model = build_model(mvit_cfg(), device="cpu")
    model.load_state_dict(sd, strict=True)
    video = torch.from_numpy(data["video"].transpose(0, 2, 3, 4, 1).copy())
    with torch.no_grad():
        out = model(video)
    np.testing.assert_allclose(out.numpy(), data["out"], rtol=0,
                               atol=FIXTURE_ATOL)


def test_multiscale_attention_fixture():
    """The reference's ``MultiScaleAttention`` (conv pooling of q at stride
    1 and of k, v at (1, 2, 2), CLS on): the output within 3e-5 and the
    pooled query grid."""
    data, sd = load_fixture("multiscale_attention")
    C = data["x"].shape[-1]
    attn = tmvit.MultiScaleAttention(
        C, int(data["num_heads"]), qkv_bias=True, kernel_q=(1, 3, 3),
        kernel_kv=(1, 3, 3), stride_q=(1, 1, 1), stride_kv=(1, 2, 2))
    attn.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out, thw = attn(torch.from_numpy(data["x"]), tuple(data["thw"]))
    assert list(thw) == list(data["out_thw"])
    np.testing.assert_allclose(out.numpy(), data["out"], rtol=0,
                               atol=ATTN_FIXTURE_ATOL)


def test_bridge_names_are_the_references():
    """The flax paths of the fixture's MViT (the JAX ``AttentionPool``'s
    ``pool`` / ``norm`` under ``pool_q`` ..., ``patch_embed_proj``) map to
    exactly the reference's state-dict names of ``mvit_full.npz``."""
    from focus_tpu.models.build import build_model as jax_build_model

    _, sd = load_fixture("mvit_full")
    jmodel = jax_build_model(jax_cfg_like(mvit_cfg()))
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 64, 64, 3))))
    params = draw_like(shapes["params"])
    assert set(jax_params_to_state_dict(params)) == set(sd)
    assert "blocks.1.attn.pool_q.weight" in sd
    assert "blocks.1.attn.norm_q.bias" in sd


# ---- MultiScaleAttention ----------------------------------------------------

@pytest.mark.parametrize("cls_on", [True, False], ids=["cls", "no_cls"])
@pytest.mark.parametrize("pool_first", [False, True],
                         ids=["pool_after", "pool_first"])
@pytest.mark.parametrize("mode", ["conv", "avg", "max"])
def test_multiscale_attention_matches_jax(mode, pool_first, cls_on):
    """One attention of 2 heads over a 2 x 5 x 5 grid (the windows reach
    past its edges, where avg divides by the valid cells alone), q pooled
    at (1, 2, 2) and k, v at (2, 2, 2), in each pooling mode, pooled before
    or after the projections, with and without the CLS token: the output
    and the pooled grid against JAX's within 1e-5."""
    from focus_tpu.models.mvit import MultiScaleAttention

    C, heads, thw = 16, 2, (2, 5, 5)
    kw = dict(kernel_q=(3, 3, 3), kernel_kv=(3, 3, 3), stride_q=(1, 2, 2),
              stride_kv=(2, 2, 2), has_cls_embed=cls_on, mode=mode,
              pool_first=pool_first)
    x = np.random.RandomState(1).randn(
        2, int(cls_on) + math.prod(thw), C).astype(np.float32)
    jmod = MultiScaleAttention(C, heads, qkv_bias=True, **kw)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x), thw))
    params = draw_like(shapes["params"])
    want, want_thw = jmod.apply({"params": params}, jnp.asarray(x), thw)
    attn = tmvit.MultiScaleAttention(C, heads, qkv_bias=True, **kw)
    load_jax_params(attn, params)
    with torch.no_grad():
        got, got_thw = attn(torch.from_numpy(x), thw)
    assert tuple(got_thw) == tuple(want_thw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATTN_ATOL)


# ---- the model --------------------------------------------------------------

EVAL_VARIANTS = {
    "base": {},
    "sep_pos_embed_norm_stem": {"MVIT.SEP_POS_EMBED": True,
                                "MVIT.NORM_STEM": True},
    "no_cls_mean_pool": {"MVIT.CLS_EMBED_ON": False,
                         "MVIT.SEP_POS_EMBED": True},
    "ignore_111_kv_kernel": {"MVIT.POOL_KV_IGNORE_111_KERNEL": True,
                             "MVIT.POOL_KV_STRIDE_ADAPTIVE": [1, 2, 2],
                             "MVIT.POOL_KVQ_KERNEL": None},
    "patch_2d": {"MVIT.PATCH_2D": True, "MVIT.PATCH_KERNEL": [7, 7],
                 "MVIT.PATCH_STRIDE": [4, 4], "MVIT.PATCH_PADDING": [3, 3],
                 "MVIT.POOL_KVQ_KERNEL": [1, 3, 3], "DATA.NUM_FRAMES": 2},
}


@pytest.mark.parametrize("name", sorted(EVAL_VARIANTS))
def test_eval_forward_matches_jax(name):
    """The eval forward of JAX's MViT and of the port's with the same
    weights: probabilities within 1e-5.
    ``patch_2d`` is the ImageNet yaml's stem, a 2-D conv that flax applies
    frame by frame to the 5-D clip; ``ignore_111_kv_kernel`` leaves k and v
    unpooled where their stride is 1 x 1 x 1 (blocks 1-3 here)."""
    cfg = mvit_cfg(**EVAL_VARIANTS[name])
    x = clip(cfg)
    jmodel, params, model = jax_pair(cfg, jnp.asarray(x))
    want = jax.jit(lambda p, v: jmodel.apply({"params": p}, v))(
        params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=PROB_ATOL)


def test_epic_kitchens_heads():
    """``TRAIN.DATASET`` epickitchens: a verb head [97] and a noun head
    [300] on the CLS token, ``(zeros(1), {"verb", "noun"})``, the softmax of
    each in eval and the logits in training. JAX's model builds the same
    heads from a dict of class counts, which flax freezes into a
    ``FrozenDict`` that its ``isinstance(..., dict)`` test misses (init
    raises a ``TypeError``). So the backbone is held against JAX's (its
    final LayerNorm's output, captured) and the heads against that
    feature through the JAX head's float32 projection, within 1e-5 (no
    drop path: the two draw apart)."""
    cfg = mvit_cfg(**{"MVIT.DROPPATH_RATE": 0.0})
    x = clip(cfg)
    jmodel, params, _ = jax_pair(cfg, jnp.asarray(x))
    _, inter = jax.jit(lambda p, v: jmodel.apply(
        {"params": p}, v, capture_intermediates=True))(params, jnp.asarray(x))
    feat = np.asarray(inter["intermediates"]["norm"]["__call__"][0])[:, 0]
    cfg.TRAIN.DATASET = "epickitchens"
    model = build_model(cfg, device="cpu")
    rs = np.random.RandomState(7)
    heads = {k: (rs.randn(n, 48).astype(np.float32) / 7.0,
                 0.1 * rs.randn(n).astype(np.float32))
             for k, n in (("verb", 97), ("noun", 300))}
    sd = {k: v for k, v in jax_params_to_state_dict(params).items()
          if not k.startswith("head.")}
    for k, (w, b) in heads.items():
        sd[f"head.projection_{k}.weight"] = torch.from_numpy(w)
        sd[f"head.projection_{k}.bias"] = torch.from_numpy(b)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        zeros, probs = model(torch.from_numpy(x))
        _, logits = model(torch.from_numpy(x), train=True)
    assert zeros.shape == (1,) and not zeros.any()
    assert sorted(probs) == ["noun", "verb"]
    for k, (w, b) in heads.items():
        want = feat @ w.T + b
        np.testing.assert_allclose(logits[k].numpy(), want, rtol=0,
                                   atol=PROB_ATOL * np.abs(want).max())
        want = np.exp(want - want.max(-1, keepdims=True))
        np.testing.assert_allclose(probs[k].numpy(),
                                   want / want.sum(-1, keepdims=True),
                                   rtol=0, atol=PROB_ATOL)


def test_detection_head_matches_jax():
    """``DETECTION.ENABLE``: the last tokens as an NCDHW volume through the
    RoI head (temporal mean, RoIAlign, spatial max, sigmoid), per box, as
    JAX's within 1e-5."""
    cfg = mvit_cfg(**{"DETECTION.ENABLE": True, "DETECTION.ALIGNED": True,
                      "DETECTION.ROI_XFORM_RESOLUTION": 3,
                      "DETECTION.SPATIAL_SCALE_FACTOR": 8,
                      "MODEL.HEAD_ACT": "sigmoid"})
    x = clip(cfg)
    boxes = np.array([[[4, 6, 40, 50], [10, 2, 60, 30], [0, 0, 63, 63]]] * 2,
                     np.float32)
    jmodel, params, model = jax_pair(cfg, jnp.asarray(x), None,
                                     jnp.asarray(boxes))
    want = jax.jit(lambda p, v, b: jmodel.apply({"params": p}, v, None, b))(
        params, jnp.asarray(x), jnp.asarray(boxes))
    with torch.no_grad():
        got = model(torch.from_numpy(x), bboxes=torch.from_numpy(boxes))
    assert got.shape == (2, 3, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=PROB_ATOL)


def _cross_entropy_jax(logits, labels):
    return -jnp.take_along_axis(jax.nn.log_softmax(logits), labels[:, None],
                                1).mean()


def test_train_logits_and_gradients_match_jax():
    """Train mode (no dropout, no drop path: the two packages draw apart):
    the float32 logits and the gradient of the cross-entropy in every
    parameter against ``jax.value_and_grad`` of the JAX model, each within
    1e-4 of the tensor's largest value."""
    cfg = mvit_cfg()
    cfg.MVIT.DROPPATH_RATE = 0.0
    x = clip(cfg)
    labels = np.array([2, 5])
    jmodel, params, model = jax_pair(cfg, jnp.asarray(x))

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x), train=True)
        return _cross_entropy_jax(logits, jnp.asarray(labels)), logits

    (_, want_logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    model.train()
    logits = model(torch.from_numpy(x), train=True)
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels)
                                      ).backward()
    want_logits = np.asarray(want_logits)
    np.testing.assert_allclose(t2n(logits), want_logits, rtol=0,
                               atol=TRAIN_RTOL * np.abs(want_logits).max())
    want = jax_grads_to_state_dict(jax.device_get(grads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    largest = max(float(g.abs().max()) for g in want.values())
    scale = {n: largest if n.endswith("norm_k.bias")
             else float(g.abs().max()) for n, g in want.items()}
    bad = {n: float((got[n] - want[n]).abs().max()) for n in want
           if not (got[n] - want[n]).abs().max() <= TRAIN_RTOL * scale[n]}
    assert not bad, bad


def test_w8a8_forward_matches_jax(monkeypatch):
    """``TPU.INT8_SERVING``: q, k, v, proj and the MLPs of the 4 blocks (24
    layers) as dynamic W8A8 dense layers in eval, each against JAX's
    ``quantized_dense`` on the activations it was given (1e-5); the
    probabilities against JAX's W8A8 forward on the same weights (5e-3) and
    within 0.05 of the port's float forward, as
    ``test_int8_mvit_runs_and_reuses_params`` holds JAX; the state dict is
    the float model's."""
    from focus_tpu.ops.quant import quantized_dense
    from focus_tpu_torch.models import motionformer

    cfg = mvit_cfg(**{"TPU.INT8_SERVING": True})
    x = clip(cfg)
    jmodel, params, model = jax_pair(cfg, jnp.asarray(x))
    want = jax.jit(lambda p, v: jmodel.apply({"params": p}, v))(
        params, jnp.asarray(x))
    calls, w8a8 = [], motionformer.quantized_linear

    def recorded(inp, layer):
        out = w8a8(inp, layer)
        calls.append((inp, layer, out))
        return out

    monkeypatch.setattr(motionformer, "quantized_linear", recorded)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        plain = build_model(mvit_cfg(), device="cpu")
        plain.load_state_dict(model.state_dict(), strict=True)
        float_probs = plain(torch.from_numpy(x))
    assert len(calls) == 24
    quantized_dense = jax.jit(quantized_dense)
    for inp, layer, out in calls:
        ref = quantized_dense(jnp.asarray(t2n(inp)),
                              jnp.asarray(t2n(layer.weight).T),
                              jnp.asarray(t2n(layer.bias)))
        np.testing.assert_allclose(t2n(out), np.asarray(ref), rtol=0,
                                   atol=INT8_LAYER_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=INT8_ATOL)
    assert float((got - float_probs).abs().max()) < 0.05


# ---- ORViT inside MViT ------------------------------------------------------

def orvit_cfg(zero_init=False):
    """ORViT blocks in place of block 2 and beside block 3 (2 objects, the
    motion stream on), as ``test_zero_init_orvit_add_layers`` builds
    them. An ORViT block keeps its input's grid and width, so neither
    package adds one beside a block that pools its queries or widens its
    tokens (blocks 1 and 0 here)."""
    return mvit_cfg(**{"ORVIT.ENABLE": True, "ORVIT.LAYERS": [2],
                       "ORVIT.ADD_LAYERS": [3], "ORVIT.O": 2,
                       "ORVIT.ZERO_INIT_ORVIT": zero_init})


def test_orvit_layers_match_jax():
    """``ORVIT.LAYERS`` and ``ORVIT.ADD_LAYERS``: the eval probabilities on
    the same boxes against JAX's within 1e-5, the trajectory attention on
    its plain path at head dim 12 (the kernels take 64 alone)."""
    cfg = orvit_cfg()
    x, boxes = clip(cfg), orvit_boxes(cfg)
    meta = {"orvit_bboxes": jnp.asarray(boxes)}
    jmodel, params, model = jax_pair(cfg, jnp.asarray(x), meta)
    want = jax.jit(lambda p, v, m: jmodel.apply({"params": p}, v, m))(
        params, jnp.asarray(x), meta)
    assert any(n.startswith("orvit_blocks.3.") for n, _ in
               model.named_parameters())
    with torch.no_grad():
        got = model(torch.from_numpy(x),
                    {"orvit_bboxes": torch.from_numpy(boxes)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=PROB_ATOL)


def test_zero_init_orvit_zeroes_the_added_blocks():
    """``ORVIT.ZERO_INIT_ORVIT`` zeroes every parameter of the added ORViT
    blocks (``orvit_blocks.*``) and no other of a model drawn at random:
    the names JAX's ``maybe_zero_init_orvit`` zeroes, carried by the
    bridge."""
    from focus_tpu.models.build import build_model as jax_build_model
    from focus_tpu.models.build import maybe_zero_init_orvit as jax_zero

    cfg = orvit_cfg(zero_init=True)
    model = build_model(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0), scale=0.02)
    maybe_zero_init_orvit(cfg, model)
    zeroed = {n for n, p in model.named_parameters() if not p.abs().max()}
    jcfg = jax_cfg_like(cfg)
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(clip(cfg)),
        {"orvit_bboxes": jnp.asarray(orvit_boxes(cfg))}))
    params = jax_zero(jcfg, draw_like(shapes["params"]))
    want = {n for n, v in jax_params_to_state_dict(params).items()
            if not v.abs().max()}
    assert zeroed == want
    assert zeroed and all(n.startswith("orvit_blocks.") for n in zeroed)


# ---- the yamls, the builder ------------------------------------------------

MVIT_YAMLS = sorted(
    glob.glob(os.path.join(REPO, "configs", "*", "MVIT*.yaml"))
    + glob.glob(os.path.join(REPO, "configs", "Kinetics", "pytorchvideo",
                             "MVIT*.yaml")))


@pytest.mark.parametrize("yaml", MVIT_YAMLS,
                         ids=lambda p: os.path.relpath(
                             p, os.path.join(REPO, "configs")))
def test_mvit_yaml_builds_and_runs(yaml):
    """Every MViT yaml (Kinetics 16x4 and 32x3, its pytorchvideo form,
    ImageNet's 2-D stem, AVA's detection head) builds at its architecture
    with the width cut (D=8; 4 frames where the yaml has more) and scores a
    32-px clip: probabilities that sum to 1 (AVA: a sigmoid per box and
    class), the registry's class for PTVMViT."""
    cfg = get_cfg()
    cfg.merge_from_file(yaml)
    cfg.MVIT.EMBED_DIM = 8
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.NUM_FRAMES = min(cfg.DATA.NUM_FRAMES, 4)
    cfg.MODEL.NUM_CLASSES = 5
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = build_model(cfg, device="cpu")
    assert isinstance(model, tmvit.MViT)
    assert MODEL_REGISTRY[cfg.MODEL.MODEL_NAME] is tmvit.MViT
    x = torch.rand(1, cfg.DATA.NUM_FRAMES, 32, 32, 3,
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        if cfg.DETECTION.ENABLE:
            p = model([x], bboxes=torch.tensor([[[2.0, 3.0, 20.0, 30.0]]]))
            assert p.shape == (1, 1, 5) and ((p > 0) & (p < 1)).all()
        else:
            p = model([x])
            assert p.shape == (1, 5)
            assert abs(p.sum().item() - 1.0) < 1e-5
    assert torch.isfinite(p).all()


def test_unported_options_raise():
    """``MVIT.DROPOUT_RATE`` > 0 raises naming itself, and ``MVIT.NORM``
    other than layernorm raises as JAX's model does."""
    with pytest.raises(NotImplementedError, match="MVIT.DROPOUT_RATE"):
        build_model(mvit_cfg(**{"MVIT.DROPOUT_RATE": 0.1}), device="cpu")
    with pytest.raises(NotImplementedError, match="layernorm"):
        build_model(mvit_cfg(**{"MVIT.NORM": "batchnorm"}), device="cpu")


def test_round_width_is_one_copy():
    """The ResNet family's X3D widths use MViT's ``round_width`` (JAX's
    resnet imports it from mvit too), and it rounds as the JAX one."""
    from focus_tpu.models.mvit import round_width as jax_round_width
    from focus_tpu_torch.models import resnet_video

    assert resnet_video.round_width is tmvit.round_width
    for args in ((96, 2.0), (24, 2.25, 8, 8), (12, 1.5), (7, 0.0), (
            54, 2.2, 1, 8)):
        assert tmvit.round_width(*args) == jax_round_width(*args)


# ---- where the convolutions run --------------------------------------------

@pytest.mark.parametrize("name", ["slowfast", "mvit"])
def test_bf16_forward_convolves_in_bf16(name):
    """Every convolution of the bf16 eval forward of SlowFast (tiny, 110
    convolutions) and of MViT (its stem and the pooling convolutions)
    takes a bf16 input and a bf16 weight: no float32 tensor reaches a
    convolution, as in the JAX models, whose flax convolutions run at the
    compute dtype. So a float32-named cuDNN kernel in the card's profile of
    these forwards is cuDNN's choice for bf16 operands."""
    from torch.overrides import TorchFunctionMode

    from focus_tpu_torch.entry import (
        mvit_cfg as tiny_mvit_cfg,
        mvit_inputs,
        slowfast_cfg,
        slowfast_inputs,
    )

    seen = []

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.nn.functional.conv3d,
                        torch.nn.functional.conv2d):
                seen.append((args[0].dtype, args[1].dtype))
            return func(*args, **(kwargs or {}))

    if name == "slowfast":
        cfg = slowfast_cfg(tiny=True)
        inputs = slowfast_inputs(cfg, 1, 0, "cpu", cfg.DATA.TRAIN_CROP_SIZE)
    else:
        cfg = tiny_mvit_cfg(tiny=True)
        inputs = mvit_inputs(cfg, 1, 0, "cpu")
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    model = build_model(cfg, device="cpu")
    with torch.no_grad(), Record():
        model(inputs)
    assert seen
    assert set(seen) == {(torch.bfloat16, torch.bfloat16)}, set(seen)


def test_op_groups_name_the_kinds():
    """``profile_slice.op_groups`` sorts the device kernels of the MViT
    and ResNet profiles by kind: cuDNN's convolutions apart from cuBLAS's
    GEMMs, softmax, LayerNorm and GELU apart from the other elementwise
    kernels."""
    from focus_tpu_torch.profile_slice import op_groups

    rows = [("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_ndhwc", 2,
             10.0),
            ("cudnn::ops::nchwToNhwcKernel<__nv_bfloat16>", 1, 1.0),
            ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32", 4,
             20.0),
            ("void cunn_SoftMaxForward<4, float, float>", 1, 3.0),
            ("void at::native::vectorized_layer_norm_kernel<float, float>", 2,
             4.0),
            ("void at::native::vectorized_elementwise_kernel<4, "
             "GeluCUDAKernelImpl>", 1, 5.0),
            ("void at::native::vectorized_elementwise_kernel<4, "
             "CUDAFunctor_add<float>>", 1, 6.0)]
    groups = op_groups(rows, iters=1)
    ms = {k: v["device_ms_per_call"] for k, v in groups.items()}
    assert ms == {"convolutions": 0.01, "layout transforms": 0.001,
                  "GEMMs": 0.02, "softmax": 0.003, "LayerNorm": 0.004,
                  "GELU": 0.005,
                  "other elementwise (BatchNorm's normalisation, ReLU, adds)":
                      0.006}
