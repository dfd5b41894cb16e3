"""The port's modules against the golden fixtures (reference state_dicts
loaded with ``strict=True``) and the whole slice against the JAX model on
the same weights, carried across by ``utils/weights.py``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu_torch.config import get_cfg
from focus_tpu_torch.models.build import build_model
from focus_tpu_torch.models.motionformer import TrajectoryAttention
from focus_tpu_torch.models.orvit import ORViTBlock
from focus_tpu_torch.utils.weights import jax_params_to_state_dict, load_jax_params

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def load(name):
    data = dict(np.load(os.path.join(FIXDIR, f"{name}.npz")))
    sd = {k[3:]: torch.from_numpy(v) for k, v in data.items()
          if k.startswith("sd/")}
    rest = {k: v for k, v in data.items() if not k.startswith("sd/")}
    return rest, sd


def mf_full_cfg(get_cfg_fn, orvit_layers=(), depth=3):
    """As tests/test_full_model_golden.py:mf_full_cfg, for either package."""
    cfg = get_cfg_fn()
    cfg.MODEL.MODEL_NAME = "Motionformer"
    cfg.MODEL.NUM_CLASSES = 7
    cfg.TRAIN.DATASET = "ssv2"
    cfg.DATA.TRAIN_CROP_SIZE = 224
    cfg.MF.PATCH_SIZE = 56
    cfg.MF.PATCH_SIZE_TEMP = 2
    cfg.MF.EMBED_DIM = 24
    cfg.MF.DEPTH = depth
    cfg.MF.NUM_HEADS = 2
    cfg.MF.MLP_RATIO = 4
    cfg.MF.QKV_BIAS = True
    cfg.MF.TEMPORAL_RESOLUTION = 2
    cfg.MF.USE_MLP = True
    cfg.ORVIT.LAYERS = list(orvit_layers)
    cfg.ORVIT.ENABLE = bool(orvit_layers)
    cfg.ORVIT.O = 3
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def test_trajectory_attention_golden():
    d, sd = load("trajectory_attention_orig")
    C = d["x"].shape[-1]
    mod = TrajectoryAttention(C, int(d["num_heads"]), qkv_bias=True)
    mod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(d["x"]), tuple(int(t) for t in d["thw"]))
    np.testing.assert_allclose(out.numpy(), d["out"], atol=3e-5)


def test_orvit_block_golden():
    d, sd = load("orvit_block")
    cfg = get_cfg()
    cfg.ORVIT.O = 3
    cfg.ORVIT.USE_MOTION_STREAM = True
    cfg.ORVIT.MOTION_STREAM_ATTN_TYPE = "joint"
    cfg.DATA.NUM_FRAMES = 4
    C = d["x"].shape[-1]
    thw = tuple(int(t) for t in d["thw"])
    mod = ORViTBlock(cfg, dim=C, num_heads=4, qkv_bias=True, nb_frames=thw[0])
    mod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(d["x"]),
                  {"orvit_bboxes": torch.from_numpy(d["boxes"])}, thw)
    np.testing.assert_allclose(out.numpy(), d["out"], atol=2e-4)


@pytest.mark.parametrize("name,orvit_layers,atol", [
    ("motionformer_full", (), 2e-5),
    ("orvit_mf_full", (1,), 2e-4),
])
def test_full_model_golden(name, orvit_layers, atol):
    d, sd = load(name)
    model = build_model(mf_full_cfg(get_cfg, orvit_layers), device="cpu")
    model.load_state_dict(sd, strict=True)
    video = torch.from_numpy(d["video"].transpose(0, 2, 3, 4, 1).copy())
    meta = {"orvit_bboxes": torch.from_numpy(d["boxes"])} if "boxes" in d else {}
    with torch.no_grad():
        out = model(video, meta)
    np.testing.assert_allclose(out.numpy(), d["out"], atol=atol)


def jax_model_and_params(orvit_layers, depth, scan, seed=0):
    from focus_tpu.config import get_cfg as jax_get_cfg
    from focus_tpu.models.build import build_model as jax_build_model
    from focus_tpu.models.build import init_model

    cfg = mf_full_cfg(jax_get_cfg, orvit_layers, depth)
    cfg.TPU.SCAN_LAYERS = scan
    rs = np.random.RandomState(seed)
    video = rs.rand(2, 4, 224, 224, 3).astype(np.float32)
    boxes = (rs.rand(2, 2, 3, 4) * 0.5 + 0.25).astype(np.float32)
    model = jax_build_model(cfg)
    meta = {"orvit_bboxes": jnp.asarray(boxes)}
    variables = init_model(model, cfg, (jnp.asarray(video), meta),
                           rng=jax.random.PRNGKey(seed))
    params = jax.device_get(variables["params"])
    return cfg, model, params, video, boxes


def test_slice_matches_jax_model_on_same_weights():
    """Small f32 ORViT-MF (D=24, 2 heads, depth 4, ORViT at [1], O=3) with
    blocks 2-3 as a scanned stack: JAX init -> weight bridge -> port."""
    cfg, jmodel, params, video, boxes = jax_model_and_params((1,), 4, True)
    assert any(k.startswith("blocks_2_3") for k in params)
    ref = np.asarray(jmodel.apply(
        {"params": params}, jnp.asarray(video),
        {"orvit_bboxes": jnp.asarray(boxes)},
    ))
    model = build_model(mf_full_cfg(get_cfg, (1,), 4), device="cpu")
    load_jax_params(model, params)
    with torch.no_grad():
        out = model(torch.from_numpy(video),
                    {"orvit_bboxes": torch.from_numpy(boxes)}).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)
    assert (out.argmax(-1) == ref.argmax(-1)).all()


@pytest.mark.parametrize("orvit_layers,depth,scan", [
    ((1,), 4, True),
    ((1, 2), 3, False),
    ((), 3, True),
])
def test_weight_bridge_keys_match_port(orvit_layers, depth, scan):
    """The converter gives exactly the port's state_dict keys and shapes."""
    _, _, params, _, _ = jax_model_and_params(orvit_layers, depth, scan)
    sd = jax_params_to_state_dict(params)
    want = build_model(mf_full_cfg(get_cfg, orvit_layers, depth),
                       device="cpu").state_dict()
    assert sorted(sd) == sorted(want)
    assert all(sd[k].shape == want[k].shape for k in want)


def test_weight_bridge_reports_missing_and_unexpected():
    _, _, params, _, _ = jax_model_and_params((1,), 4, True)
    model = build_model(mf_full_cfg(get_cfg, (1,), 3), device="cpu")
    with pytest.raises(KeyError, match="unexpected keys"):
        load_jax_params(model, params)
    params = dict(params)
    params.pop("head")
    model = build_model(mf_full_cfg(get_cfg, (1,), 4), device="cpu")
    with pytest.raises(KeyError, match="head.weight"):
        load_jax_params(model, params)
