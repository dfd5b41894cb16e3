"""Package rules of the PyTorch port: no JAX import anywhere in it, entry
points that default to CUDA and raise without it, wrappers that take the
plain version only for CPU tensors, and the CUDA sources they bind."""

import ast
import math
import os
import re

import pytest
import torch

import focus_tpu_torch
from focus_tpu_torch.config import get_cfg
from focus_tpu_torch.entry import entry, flagship_cfg, train_cfg, train_entry
from focus_tpu_torch.models.build import build_model
from focus_tpu_torch.ops import (
    _build,
    ar_decode,
    patch_embed,
    trajectory_attention,
    trajectory_block,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(focus_tpu_torch.__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "focus_tpu")


def _port_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_port_files()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(flagship_cfg(tiny=True))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_entry(tiny=True)


def test_entry_on_cpu_runs_tiny_slice():
    fn, (video, boxes) = entry(device="cpu", batch=2, tiny=True)
    probs = fn(video, boxes)
    assert probs.shape == (2, 174) and probs.dtype == torch.float32
    assert torch.isfinite(probs).all()
    torch.testing.assert_close(probs.sum(-1), torch.ones(2))
    fn.model.use_kernels = False
    torch.testing.assert_close(fn(video, boxes), probs, rtol=0, atol=0)


def test_train_mode_returns_logits():
    fn, (video, boxes) = entry(device="cpu", batch=1, tiny=True)
    meta = {"orvit_bboxes": boxes}
    logits = fn.model(video, meta, train=True)
    assert logits.shape == (1, 174) and logits.dtype == torch.float32
    torch.testing.assert_close(torch.softmax(logits, -1).detach(),
                               fn(video, boxes))


@pytest.mark.parametrize("key,value", [
    ("MF.ATTN_DROPOUT", 0.1), ("MF.DROP", 0.1), ("MF.POS_DROPOUT", 0.1),
    ("MF.HEAD_DROPOUT", 0.1),
])
def test_dropout_outside_the_slice_raises(key, value):
    cfg = flagship_cfg(tiny=True)
    section, name = key.split(".")
    setattr(getattr(cfg, section), name, value)
    with pytest.raises(NotImplementedError):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("key,value", [
    ("TPU.MESH.SEQ", 2),
    ("TPU.MESH.EXPERT", 2), ("TPU.REMAT", True), ("TPU.ZERO1", True),
])
def test_train_options_outside_the_slice_raise(key, value):
    from focus_tpu_torch.engine.trainer import make_supervised_train_step
    from focus_tpu_torch.models.losses import get_loss_func

    cfg = train_cfg(tiny=True)
    *path, name = key.split(".")
    node = cfg
    for part in path:
        node = getattr(node, part)
    setattr(node, name, value)
    with pytest.raises(NotImplementedError, match=key):
        make_supervised_train_step(None, cfg, get_loss_func(cfg))


def test_ek_loss_raises():
    """EK_loss is ported (the JAX package's verb + noun sum): on the dual
    head's pair of zero logits it gives ln 97 + ln 300, and it raises
    KeyError where a head's labels are missing, as the JAX function does."""
    from focus_tpu_torch.models.losses import get_loss_func

    loss = get_loss_func("EK_loss")
    verb, noun = torch.zeros(2, 97), torch.zeros(2, 300)
    ids = torch.zeros(2, dtype=torch.long)
    got = loss((verb, {"verb": verb, "noun": noun}), {"verb": ids,
                                                      "noun": ids})
    assert got.item() == pytest.approx(math.log(97) + math.log(300))
    with pytest.raises(KeyError, match="noun"):
        loss((verb, {"verb": verb, "noun": noun}), {"verb": ids})


def test_wrappers_refuse_other_devices():
    q = torch.zeros(1, 4, 64, device="meta")
    kf = torch.zeros(1, 2, 2, 64, device="meta")
    w = torch.zeros(64, 64, device="meta")
    b = torch.zeros(64, device="meta")
    with pytest.raises(ValueError, match="no trajectory kernel"):
        trajectory_block.fused_trajectory_core(q, kf, kf, w, b, w, b, 0.125, 1)
    x = torch.zeros(1, 2, 16, 16, 3, device="meta")
    with pytest.raises(ValueError, match="no patch-embed kernel"):
        patch_embed.patch_embed_3d(x, torch.zeros(2, 16, 16, 3, 8, device="meta"),
                                   torch.zeros(8, device="meta"), (2, 16, 16))
    with pytest.raises(ValueError, match="no space-stage kernel"):
        trajectory_attention.space_stage(q, q, q, 2, 0.125)


@pytest.mark.parametrize("module,source,symbol", [
    (trajectory_block, "trajectory_block.cu", "traj_core_bf16"),
    (trajectory_block, "trajectory_block_bwd.cu", "traj_core_bwd_bf16"),
    (patch_embed, "patch_embed.cu", "patch_embed_bf16"),
    (ar_decode, "ar_decode.cu", "ar_decode_step_bf16"),
    (ar_decode, "ar_decode.cu", "ar_decode_step_w8a8"),
    (trajectory_attention, "trajectory_attention.cu", "space_stage_bf16"),
    (trajectory_block, "trajectory_block.cu", "traj_core_v3_bf16"),
    (trajectory_block, "trajectory_block_v5.cu", "traj_core_v5_bf16"),
    (trajectory_block, "trajectory_block_v6.cu", "traj_core_v6_bf16"),
    (trajectory_block, "trajectory_block.cu", "traj_core_v7_bf16"),
])
def test_wrappers_bind_their_cuda_sources(module, source, symbol):
    with open(os.path.join(PKG, "csrc", source)) as f:
        text = f.read()
    assert re.search(rf'extern "C" int {symbol}\(', text)
    with open(module.__file__) as f:
        assert f'"{symbol}"' in f.read()


def test_repo_yaml_loads_in_port_config():
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ORViT",
                                     "SSv2_ORViT-MF_224_16x4.yaml"))
    assert cfg.MODEL.MODEL_NAME == "Motionformer"
    assert cfg.TPU.COMPUTE_DTYPE in ("bfloat16", "float32")


def _c_signature(source, symbol):
    """(#pointers, #ints, #floats) of an extern "C" function, without the
    trailing stream pointer."""
    with open(os.path.join(PKG, "csrc", source)) as f:
        text = f.read()
    m = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text)
    params = [p.strip() for p in m.group(1).split(",")]
    assert params[-1] == "void* stream"
    kinds = [("ptr" if "*" in p else p.split()[0]) for p in params[:-1]]
    return kinds.count("ptr"), kinds.count("int"), kinds.count("float"), kinds


@pytest.mark.parametrize("source,symbol,n_ptr,n_int,n_float", [
    ("trajectory_block.cu", "traj_core_bf16", 9, 6, 1),
    ("trajectory_block_bwd.cu", "traj_core_bwd_bf16", 25, 6, 1),
    ("patch_embed.cu", "patch_embed_bf16", 4, 10, 0),
    ("ar_decode.cu", "ar_decode_step_bf16", 17, 7, 1),
    ("ar_decode.cu", "ar_decode_step_w8a8", 20, 7, 1),
    ("trajectory_attention.cu", "space_stage_bf16", 4, 5, 1),
    ("trajectory_block.cu", "traj_core_v3_bf16", 10, 6, 1),
    ("trajectory_block_v5.cu", "traj_core_v5_bf16", 11, 6, 1),
    ("trajectory_block_v6.cu", "traj_core_v6_bf16", 11, 6, 1),
    ("trajectory_block.cu", "traj_core_v7_bf16", 10, 6, 1),
])
def test_ctypes_binding_matches_c_signature(source, symbol, n_ptr, n_int,
                                            n_float):
    """The wrappers' ctypes argument lists agree with the C functions:
    pointers, then ints, then floats, then the stream."""
    got_ptr, got_int, got_float, kinds = _c_signature(source, symbol)
    assert (got_ptr, got_int, got_float) == (n_ptr, n_int, n_float)
    order = {"ptr": 0, "int": 1, "float": 2}
    assert [order[k] for k in kinds] == sorted(order[k] for k in kinds)
    module = {"trajectory_block.cu": trajectory_block,
              "trajectory_block_bwd.cu": trajectory_block,
              "trajectory_block_v5.cu": trajectory_block,
              "trajectory_block_v6.cu": trajectory_block,
              "trajectory_attention.cu": trajectory_attention,
              "patch_embed.cu": patch_embed, "ar_decode.cu": ar_decode}[source]
    with open(module.__file__) as f:
        text = f.read()
    assert f"n_ptr={n_ptr}, n_int={n_int}" in text
    assert (f"n_float={n_float}" in text) == (n_float > 0)


def test_every_cuda_source_is_built():
    """ops/_build.py's SOURCES names every csrc/*.cu, so build_all() (and
    chip_smoke.py's build phase) compiles each of them."""
    sources = {f[:-3] for f in os.listdir(os.path.join(PKG, "csrc"))
               if f.endswith(".cu")}
    assert set(_build.SOURCES) == sources
    assert len(_build.SOURCES) == len(sources)


@pytest.mark.parametrize("source", sorted(
    f for f in os.listdir(os.path.join(PKG, "csrc"))
    if f.endswith((".cu", ".cuh"))))
def test_cuda_sources_include_only_cuda_and_their_own_headers(source):
    """Every csrc source includes the CUDA toolkit's headers and the other
    csrc headers alone: no PyTorch header (a plain C interface, built in
    seconds) and no header from outside the package."""
    with open(os.path.join(PKG, "csrc", source)) as f:
        includes = re.findall(r'^#include\s+([<"][^>"]+[>"])', f.read(), re.M)
    csrc = set(os.listdir(os.path.join(PKG, "csrc")))
    for inc in includes:
        name = inc[1:-1]
        if inc.startswith('"'):
            assert name in csrc and name.endswith(".cuh"), (source, inc)
        else:
            assert not name.startswith(("torch", "ATen", "c10", "pybind11")), (
                source, inc)
