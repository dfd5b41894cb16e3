"""The port's ResNet video family (``models/{norms,resnet_helper,heads,
resnet_video,ptv_variants}.py``) against the reference's golden fixtures
and the JAX package's models on the CPU, at small widths (R50 at
``WIDTH_PER_GROUP`` 4-8, 32-64 px crops; the JAX package has depths 50 and
101 alone).

Tolerances: the fixtures 5e-5 (``tests/test_conv_full_golden.py``'s);
forward parity with JAX 1e-5 on probabilities; running statistics 5e-5 of
each buffer's largest value (float32 in both packages on the CPU, sums in
another order over 16 or more blocks: each adds a few 2^-24 relative).
The train-mode logits 1e-3 of the largest: flax's batch variance E[x^2] -
E[x]^2 cancels, and at these random weights JAX's own float32 train
forward of slow R50 lies 2.2e-4 of the largest logit from the same forward
in float64 (the port's 4.3e-5).

JAX's parameters are drawn once from numpy over the shapes of
``jax.eval_shape`` of its init (no init compile), BatchNorm statistics and
scales randomised so that an unmapped name shows, then carried to the port
by ``utils/weights.load_jax_params``."""

import glob
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu_torch.config import get_cfg
from focus_tpu_torch.models import norms
from focus_tpu_torch.models.build import MODEL_REGISTRY, build_model
from focus_tpu_torch.utils import checkpoint as cu
from focus_tpu_torch.utils.weights import jax_params_to_state_dict, load_jax_params
from torch_port_trees import jax_cfg_like

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
FIXTURE_ATOL = 5e-5
PROB_ATOL = 1e-5
TRAIN_LOGIT_RTOL = 1e-3
STATS_RTOL = 5e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These models are small: one intra-op thread runs them as fast as
    many, and beside the other test workers many spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- configs ---------------------------------------------------------------

def _resnet_common(cfg, arch, name, classes=9, frames=4, crop=64, width=8,
                   pathways=1):
    cfg.MODEL.MODEL_NAME, cfg.MODEL.ARCH = name, arch
    cfg.MODEL.NUM_CLASSES = classes
    cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE = frames, crop
    cfg.DATA.INPUT_CHANNEL_NUM = [3] * pathways
    cfg.RESNET.DEPTH, cfg.RESNET.NUM_GROUPS = 50, 1
    cfg.RESNET.WIDTH_PER_GROUP = width
    cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[n] * pathways for n in (3, 4, 6, 3)]
    cfg.RESNET.SPATIAL_STRIDES = [[1] * pathways] + [[2] * pathways] * 3
    cfg.RESNET.SPATIAL_DILATIONS = [[1] * pathways] * 4
    cfg.NONLOCAL.LOCATION = [[[]] * pathways] * 4
    cfg.NONLOCAL.GROUP = [[1] * pathways] * 4
    cfg.NONLOCAL.POOL = [[[1, 2, 2]] * pathways] * 4
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def slowfast_cfg(detection=False, width=8, crop=64, frames=8, classes=9):
    """``scripts/make_golden_fixtures._slowfast_cfg`` (as
    ``tests/test_conv_full_golden.py`` mirrors it)."""
    cfg = _resnet_common(get_cfg(), "slowfast", "SlowFast", classes, frames,
                         crop, width, pathways=2)
    cfg.SLOWFAST.ALPHA, cfg.SLOWFAST.BETA_INV = 4, 8
    cfg.SLOWFAST.FUSION_CONV_CHANNEL_RATIO = 2
    cfg.SLOWFAST.FUSION_KERNEL_SZ = 5
    cfg.NONLOCAL.LOCATION = [[[], []], [[], []], [[1], []], [[], []]]
    cfg.NONLOCAL.INSTANTIATION = "dot_product"
    if detection:
        cfg.DETECTION.ENABLE = True
        cfg.DETECTION.ALIGNED = True
        cfg.DETECTION.ROI_XFORM_RESOLUTION = 7
        cfg.DETECTION.SPATIAL_SCALE_FACTOR = 16
        cfg.RESNET.SPATIAL_STRIDES = [[1, 1], [2, 2], [2, 2], [1, 1]]
        cfg.RESNET.SPATIAL_DILATIONS = [[1, 1], [1, 1], [1, 1], [2, 2]]
        cfg.MODEL.HEAD_ACT = "sigmoid"
    return cfg


def slow_cfg(width=8, crop=64, instantiation="softmax", arch="slow"):
    """``scripts/make_golden_fixtures._slow_cfg``: slow R50 with a softmax
    nonlocal after block 1 of res3."""
    cfg = _resnet_common(get_cfg(), arch, "ResNet", width=width, crop=crop)
    cfg.NONLOCAL.LOCATION = [[[]], [[1]], [[]], [[]]]
    cfg.NONLOCAL.INSTANTIATION = instantiation
    return cfg


def x3d_cfg(crop=64):
    """``scripts/make_golden_fixtures._x3d_cfg``."""
    cfg = _resnet_common(get_cfg(), "x3d", "X3D", crop=crop)
    cfg.RESNET.TRANS_FUNC = "x3d_transform"
    cfg.RESNET.STRIDE_1X1 = False
    cfg.X3D.DIM_C1, cfg.X3D.WIDTH_FACTOR, cfg.X3D.DEPTH_FACTOR = 12, 1.5, 1.0
    cfg.X3D.BOTTLENECK_FACTOR = 2.25
    cfg.X3D.CHANNELWISE_3x3x3, cfg.X3D.SCALE_RES2 = True, False
    cfg.X3D.DIM_C5, cfg.X3D.BN_LIN5 = 64, False
    return cfg


def i3d_cfg():
    """I3D R50 with a dot-product nonlocal (the NLN yamls' placement, one
    block), 8 frames (the temporal pool halves them), 32 px."""
    cfg = _resnet_common(get_cfg(), "i3d", "ResNet", frames=8, crop=32,
                         width=4)
    cfg.NONLOCAL.LOCATION = [[[]], [[1]], [[]], [[]]]
    cfg.NONLOCAL.INSTANTIATION = "dot_product"
    return cfg


def c2d_cfg():
    return _resnet_common(get_cfg(), "c2d", "ResNet", frames=8, crop=32,
                          width=4)


def ptv_cfg(name):
    cfg = _resnet_common(get_cfg(), "slow", name, frames=8, crop=32, width=4)
    return cfg


def subbn_cfg():
    cfg = slow_cfg(width=4, crop=32)
    cfg.BN.NORM_TYPE = "sub_batchnorm"
    cfg.BN.NUM_SPLITS = 2
    return cfg


# ---- the golden fixtures ----------------------------------------------------

def load_fixture(name):
    data = dict(np.load(os.path.join(FIXDIR, f"{name}.npz")))
    sd = {k[3:]: torch.from_numpy(v) for k, v in data.items()
          if k.startswith("sd/")}
    return data, sd


def fixture_pathways(video_bcthw, alpha=None):
    v = video_bcthw.transpose(0, 2, 3, 4, 1)  # -> [B, T, H, W, C]
    if alpha is None:
        return [torch.from_numpy(np.ascontiguousarray(v))]
    return [torch.from_numpy(np.ascontiguousarray(v[:, ::alpha])),
            torch.from_numpy(np.ascontiguousarray(v))]


FIXTURES = {
    "slowfast_full": (slowfast_cfg, 4),
    "slowfast_det_full": (lambda: slowfast_cfg(detection=True), 4),
    "x3d_full": (x3d_cfg, None),
    "slow_full": (slow_cfg, None),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reference_fixture_through_the_pyth_reader(name, tmp_path):
    """The reference's state dict (weights and randomised running
    statistics, ``num_batches_tracked`` too) written as a ``.pyth`` and read
    by ``utils/checkpoint.load_checkpoint`` loads every name of the port's
    model, with none unused; the eval forward (the RoI head's per-box
    probabilities for the detection variant) matches the executed
    reference within 5e-5."""
    make, alpha = FIXTURES[name]
    data, sd = load_fixture(name)
    path = str(tmp_path / "ref.pyth")
    torch.save({"model_state": sd, "epoch": 7}, path)
    cfg = make()
    model = build_model(cfg, device="cpu")
    report = cu.load_checkpoint(path, model, cfg)
    assert report["missing"] == [] and report["unused"] == []
    boxes = torch.from_numpy(data["boxes"]) if "boxes" in data else None
    with torch.no_grad():
        out = model(fixture_pathways(data["video"], alpha), bboxes=boxes)
    np.testing.assert_allclose(out.numpy().reshape(data["out"].shape),
                               data["out"], rtol=0, atol=FIXTURE_ATOL)


# ---- JAX parameters carried by the bridge ----------------------------------------

def jax_model(cfg):
    from focus_tpu.models.build import build_model as jax_build_model

    return jax_build_model(jax_cfg_like(cfg))


def jax_variables(jmodel, xs, seed=0):
    """Random params and batch statistics of ``jmodel``'s shapes: kernels
    N(0, 1 / fan_in), biases N(0, 0.1^2), BN scales 1 + N(0, 0.2^2), running
    means N(0, 0.1^2), running variances 1 + |N(0, 0.3^2)|."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        xs, None, train=False))
    rs = np.random.RandomState(seed)

    def draw(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        if leaf == "kernel":
            v = rs.randn(*s.shape) / math.sqrt(math.prod(s.shape[:-1]))
        elif leaf == "scale":
            v = 1.0 + 0.2 * rs.randn(*s.shape)
        elif leaf == "var":
            v = 1.0 + np.abs(0.3 * rs.randn(*s.shape))
        else:  # bias, mean
            v = 0.1 * rs.randn(*s.shape)
        return v.astype(np.float32)

    return {k: jax.tree_util.tree_map_with_path(draw, v)
            for k, v in shapes.items()}


def clips(cfg, batch=2, seed=3, crop=None):
    """Pathways [B, T, H, W, 3] as numpy: a normal clip split as
    ``pack_pathway_output`` splits a SlowFast one."""
    crop = crop or cfg.DATA.TRAIN_CROP_SIZE
    v = np.random.RandomState(seed).randn(
        batch, cfg.DATA.NUM_FRAMES, crop, crop, 3).astype(np.float32)
    if cfg.MODEL.ARCH != "slowfast":
        return [v]
    idx = np.linspace(0, v.shape[1] - 1, v.shape[1] // cfg.SLOWFAST.ALPHA
                      ).astype(np.int64)
    return [np.ascontiguousarray(v[:, idx]), v]


def port_of(cfg, variables):
    model = build_model(cfg, device="cpu")
    load_jax_params(model, variables["params"], variables["batch_stats"])
    return model


def running_stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def assert_stats_close(got, jax_stats):
    want = jax_params_to_state_dict(jax.device_get(jax_stats))
    assert sorted(got) == sorted(want)
    bad = {k: float((got[k] - want[k]).abs().max()) for k in got
           if not (got[k] - want[k]).abs().max()
           <= STATS_RTOL * want[k].abs().max()}
    assert not bad, bad


EVAL_MODELS = {
    "slow_softmax_nonlocal": slow_cfg,
    "i3d_dot_product_nonlocal": i3d_cfg,
    "c2d": c2d_cfg,
    "x3d": lambda: x3d_cfg(crop=32),
    "csn": lambda: ptv_cfg("PTVCSN"),
    "r2plus1d": lambda: ptv_cfg("PTVR2plus1D"),
}


@pytest.mark.parametrize("name", sorted(EVAL_MODELS))
def test_eval_forward_matches_jax(name):
    """The eval forward of JAX's model and of the port's with the same
    weights and statistics: probabilities within 1e-5."""
    cfg = EVAL_MODELS[name]()
    jmodel = jax_model(cfg)
    xs = clips(cfg)
    variables = jax_variables(jmodel, [jnp.asarray(x) for x in xs])
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, None))(
        variables, [jnp.asarray(x) for x in xs]))
    with torch.no_grad():
        got = port_of(cfg, variables)([torch.from_numpy(x) for x in xs])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PROB_ATOL)


def test_slowfast_eval_at_a_test_crop_above_the_train_crop():
    """SlowFast pooled at the 32-px train crop's 1 x 1 scores a 64-px clip
    (a 2 x 2 last stage) fully convolutionally: softmax at each of the 4
    positions, then their mean, as JAX's head does (1e-5)."""
    cfg = slowfast_cfg(crop=32, classes=7)
    jmodel = jax_model(cfg)
    xs = clips(cfg, crop=64)
    variables = jax_variables(jmodel, [jnp.asarray(x) for x in xs])
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, None))(
        variables, [jnp.asarray(x) for x in xs]))
    with torch.no_grad():
        got = port_of(cfg, variables)([torch.from_numpy(x) for x in xs])
    assert got.shape == (2, 7)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PROB_ATOL)


@pytest.mark.parametrize("name", ["sub_batchnorm", "batchnorm"])
def test_train_forward_and_running_stats_match_jax(name):
    """A train-mode forward of slow R50 under ``BN.NORM_TYPE``
    sub_batchnorm (2 splits: per-split statistics, one running buffer
    moved toward their mixture) and batchnorm: the logits (1e-3 of the
    largest) and every running mean and variance after it (5e-5 of the
    largest) as JAX's mutable ``batch_stats``."""
    cfg = subbn_cfg() if name == "sub_batchnorm" else slow_cfg(width=4,
                                                                crop=32)
    jmodel = jax_model(cfg)
    xs = clips(cfg, batch=4)
    variables = jax_variables(jmodel, [jnp.asarray(x) for x in xs])
    want, new_vars = jax.jit(lambda v, x: jmodel.apply(
        v, x, None, train=True, mutable=["batch_stats"]))(
        variables, [jnp.asarray(x) for x in xs])
    model = port_of(cfg, variables)
    with torch.no_grad():
        got = model([torch.from_numpy(x) for x in xs], train=True)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TRAIN_LOGIT_RTOL * np.abs(want).max())
    assert_stats_close(running_stats(model), new_vars["batch_stats"])


def test_bridge_names_are_the_references():
    """The flax paths of SlowFast (with a nonlocal) and X3D map to exactly
    the reference's state-dict names of the fixtures, BatchNorm's
    ``num_batches_tracked`` aside."""
    for name, (make, _) in (("slowfast_full", FIXTURES["slowfast_full"]),
                            ("x3d_full", FIXTURES["x3d_full"])):
        cfg = make()
        jmodel = jax_model(cfg)
        data, sd = load_fixture(name)
        xs = [jnp.asarray(x.numpy()) for x in fixture_pathways(
            data["video"], 4 if "slowfast" in name else None)]
        variables = jax_variables(jmodel, xs)
        names = set(jax_params_to_state_dict(variables["params"])) | set(
            jax_params_to_state_dict(variables["batch_stats"]))
        assert names == {k for k in sd if
                         not k.endswith("num_batches_tracked")}


# ---- the builder, the norms --------------------------------------------------------

CONV_YAMLS = sorted(
    p for p in glob.glob(os.path.join(REPO, "configs", "Kinetics", "*.yaml"))
    + glob.glob(os.path.join(REPO, "configs", "Kinetics", "pytorchvideo",
                             "*.yaml"))
    if "MVIT" not in os.path.basename(p))


@pytest.mark.parametrize("yaml", CONV_YAMLS,
                         ids=lambda p: os.path.relpath(
                             p, os.path.join(REPO, "configs", "Kinetics")))
def test_kinetics_yaml_builds_and_runs(yaml):
    """Every Kinetics yaml of the ResNet family (and of its pytorchvideo
    folder) builds at its architecture with the width cut (8 a group, or
    X3D's DIM_C1 4) and scores a 32-px clip: probabilities that sum to 1.
    Its BatchNorm scales start at 0 on each transform's last norm exactly
    where ``RESNET.ZERO_INIT_FINAL_BN`` says."""
    cfg = get_cfg()
    cfg.merge_from_file(yaml)
    cfg.RESNET.WIDTH_PER_GROUP = 8
    cfg.X3D.DIM_C1, cfg.X3D.DIM_C5 = 4, 16
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.DATA.NUM_FRAMES = 8 if cfg.MODEL.ARCH != "slowfast" else 16
    cfg.MODEL.NUM_CLASSES = 5
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = build_model(cfg, device="cpu")
    n = cfg.DATA.NUM_FRAMES
    x = torch.rand(1, n, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    xs = [x[:, ::cfg.SLOWFAST.ALPHA].contiguous(), x] if (
        cfg.MODEL.ARCH == "slowfast") else [x]
    with torch.no_grad():
        p = model(xs)
    assert p.shape == (1, 5) and torch.isfinite(p).all()
    assert abs(p.sum().item() - 1.0) < 1e-5
    zero = [m for m in model.modules()
            if isinstance(m, norms.BatchNorm) and m.zero_init]
    assert bool(zero) == bool(cfg.RESNET.ZERO_INIT_FINAL_BN) or (
        cfg.MODEL.MODEL_NAME in ("PTVCSN", "PTVR2plus1D"))
    assert all((m.weight == 0).all() for m in zero)


def test_builder_refuses_mvit_and_the_missing_card():
    """PTVMViT and MViT build (the MViT slice of the port: the registry's
    one class under both names); the registry holds the family and the PTV
    aliases; ``build_model(cfg, "cuda")`` raises where CUDA is absent (no
    move to the CPU)."""
    from focus_tpu_torch.models.mvit import MViT

    cfg = slow_cfg(width=4, crop=32)
    build_model(cfg, device="cpu")
    for name in ("SlowFast", "ResNet", "X3D", "PTVCSN", "PTVR2plus1D",
                 "PTVResNet", "PTVSlowFast", "PTVX3D"):
        assert name in MODEL_REGISTRY
    for name in ("PTVMViT", "MViT"):
        cfg.MODEL.MODEL_NAME = name
        cfg.MVIT.EMBED_DIM, cfg.MVIT.DEPTH = 8, 2
        assert isinstance(build_model(cfg, device="cpu"), MViT)
    if not torch.cuda.is_available():
        cfg.MODEL.MODEL_NAME = "ResNet"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(cfg, device="cuda")


def test_batch_norm_train_update_is_flaxs():
    """One BatchNorm in train mode on a bf16 input against flax's
    ``nn.BatchNorm`` at bf16: the biased variance into the running buffer
    at momentum 0.9 (``nn.BatchNorm3d``'s own update would take the
    unbiased one), statistics in float32, the output at bf16 (one bf16
    step)."""
    from flax import linen as fnn

    rs = np.random.RandomState(0)
    x = (rs.randn(3, 5, 2, 4, 4) * 2 + 1).astype(np.float32)
    bn = norms.BatchNorm(5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rs.rand(5).astype(np.float32) + .5))
        bn.bias.copy_(torch.from_numpy(rs.randn(5).astype(np.float32)))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        y = bn(xb, train=True)
    assert y.dtype == torch.bfloat16
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                        dtype=jnp.bfloat16)
    xj = jnp.asarray(x.transpose(0, 2, 3, 4, 1)).astype(jnp.bfloat16)
    variables = {"params": {"scale": bn.weight.detach().numpy(),
                            "bias": bn.bias.detach().numpy()},
                 "batch_stats": {"mean": np.zeros(5, np.float32),
                                 "var": np.ones(5, np.float32)}}
    yj, new = jbn.apply(variables, xj, mutable=["batch_stats"])
    np.testing.assert_allclose(
        y.float().numpy().transpose(0, 2, 3, 4, 1),
        np.asarray(yj.astype(jnp.float32)), rtol=0, atol=2 ** -7 * 8)
    for buf, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(new["batch_stats"][key]),
                                   rtol=0, atol=1e-6)
    xf = xb.float()
    biased = xf.var(dim=(0, 2, 3, 4), unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               (0.9 + 0.1 * biased).numpy(), atol=1e-6)


@pytest.mark.parametrize("name", ["kinetics", "charades", "ava"])
def test_unported_video_datasets_raise(name):
    """The Kinetics, Charades and AVA datasets (cv2 / PyAV video decode) are
    not ported: building one raises, naming it, where the registry holds no
    split of that name."""
    from focus_tpu_torch.datasets.build import build_dataset

    with pytest.raises(NotImplementedError, match=name.capitalize()):
        build_dataset(name, get_cfg(), "train")
