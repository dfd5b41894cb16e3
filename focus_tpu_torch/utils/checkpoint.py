"""Checkpoints (counterpart of ``focus_tpu/utils/checkpoint.py`` and of
the reader in ``focus_tpu/utils/torch_import.py``).

The port's format is the reference's own ``.pyth``: ``torch.save`` of
``{"model_state": state_dict, "epoch": n, "cfg": cfg.dump()}``. So one
reader serves the port's checkpoints and upstream FOCUS / PySlowFast ones:
the port's modules carry the reference's torch names and layouts, and the
reader keeps the JAX importer's rules on them:

- the state under ``model_state``, ``state_dict`` or ``model`` (else the
  payload itself), a leading ``module.`` stripped once;
- ``TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN`` / ``REPLACE_NAME_PATTERN``;
- ``TRAIN.CHECKPOINT_INFLATE`` (a 2D kernel tiled over time, divided by
  its extent), ``SPLIT_QKV_CHECKPOINT`` (q / k / v concatenated to qkv),
  ``ORVIT.LOAD_ORVIT_ATTN_LAYERS_FROM_BB`` (backbone qkv offered under
  ``orvit_``);
- a name the checkpoint lacks keeps its initial value and is logged, a
  shape mismatch is skipped with a warning, and the loaded / missing /
  unused names are reported.

The JAX package's own checkpoints (a flax msgpack state) and Caffe2
checkpoints are not read: each raises, naming its format.

Under a model or expert axis, a pipeline or ``TPU.ZERO1`` every process
gathers the shards, the stages' blocks and the optimizer's chunks and
moments first (``parallel/tensor.full_state_dict``,
``Optimizer.state_dict``), so a checkpoint keeps the bridge's full names
and shapes and the one-process optimizer's state: one written on any mesh
loads on any other, or in one process, and a sharded model loads a full
one by taking its shards and its stage.

The train loop's checkpoint is the same ``.pyth`` with the reference's
``optimizer_state`` (the ``torch.optim`` state dict: AdamW's moments) and
the port's ``step`` and ``generator_state`` beside ``model_state``, so the
test path and upstream readers read its weights as they read any other.
The copy to host memory is synchronous (the next step updates the
parameters in place); under ``TPU.ASYNC_CHECKPOINT`` the file is written
by one ordered writer thread, ``.tmp`` then rename, and every read waits
for the writes in flight (``wait_for_saves``). ``load_train_checkpoint``
resumes: the last checkpoint in OUTPUT_DIR (the slot trainer's: EXP.PATH)
under ``TRAIN.AUTO_RESUME``, else ``TRAIN.CHECKPOINT_FILE_PATH``. The slot
trainer writes the same train state as ``best_model.pt``,
``checkpoint.pt.tar`` and ``checkpoint_epoch_NNNNN.pyth``. BatchNorm
running statistics (STEVE's, the ResNet family's) are buffers of the
``model_state``, under the reference's names, ``num_batches_tracked``
among them (read and written, never used).
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Dict, Optional

import torch

from focus_tpu_torch.parallel import tensor as tp
from focus_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

CKPT_DIR = "checkpoints"


def make_checkpoint_dir(path_to_job: str, exp_name: Optional[str] = None) -> str:
    d = get_checkpoint_dir(path_to_job, exp_name)
    if logging.is_master_process():
        os.makedirs(d, exist_ok=True)
    return d


def get_checkpoint_dir(path_to_job: str, exp_name: Optional[str] = None) -> str:
    if exp_name:
        return os.path.join(path_to_job, exp_name, CKPT_DIR)
    return os.path.join(path_to_job, CKPT_DIR)


def get_path_to_checkpoint(path_to_job: str, epoch: int, fmt: str = ".pyth") -> str:
    name = "checkpoint_epoch_{:05d}{}".format(epoch, fmt)
    return os.path.join(get_checkpoint_dir(path_to_job), name)


def get_last_checkpoint(path_to_job: str) -> Optional[str]:
    d = get_checkpoint_dir(path_to_job)
    names = (
        [f for f in os.listdir(d) if f.startswith("checkpoint_epoch_")]
        if os.path.exists(d)
        else []
    )
    if not names:
        return None
    return os.path.join(d, sorted(names)[-1])


def has_checkpoint(path_to_job: str) -> bool:
    return get_last_checkpoint(path_to_job) is not None


def is_checkpoint_epoch(cfg, cur_epoch: int, multigrid_schedule=None) -> bool:
    """Whether to save after ``cur_epoch``: the last epoch, each
    TRAIN.CHECKPOINT_PERIOD-th, or under a multigrid schedule
    MULTIGRID.EVAL_FREQ times a stage (reference checkpoint.py:76-98)."""
    if cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH:
        return True
    if multigrid_schedule is not None:
        prev_epoch = 0
        for s in multigrid_schedule:
            if cur_epoch < s[-1]:
                period = max(
                    (s[-1] - prev_epoch) // cfg.MULTIGRID.EVAL_FREQ + 1, 1
                )
                return (s[-1] - 1 - cur_epoch) % period == 0
            prev_epoch = s[-1]
    return (cur_epoch + 1) % cfg.TRAIN.CHECKPOINT_PERIOD == 0


def _host_copy(tree):
    """``tree`` with every tensor copied to the CPU (a copy even where it
    lies there already)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


# the keys a train-state checkpoint adds to the weights' ``.pyth``
TRAIN_STATE_KEYS = ("optimizer_state", "step", "generator_state")

_PENDING_SAVES: list = []


def save_checkpoint(path_to_job: str, state, epoch: int, cfg,
                    name: Optional[str] = None, fmt: str = ".pyth",
                    async_write: Optional[bool] = None) -> Optional[str]:
    """Write ``state`` to the epoch's checkpoint, or to ``name + fmt`` in
    the checkpoint directory: a module's weights, or a ``TrainState``'s
    weights, optimizer state, step and generator state. Rank 0 alone
    writes, through a ``.tmp`` file renamed into place; the copy to host
    memory is made before this returns. With ``async_write`` (default
    ``TPU.ASYNC_CHECKPOINT``) the file is written on a writer thread
    chained behind the earlier ones. A sharded state (model axis,
    ``TPU.ZERO1``, expert axis, pipeline stages) is gathered first, by
    every process. Returns the path."""
    model = getattr(state, "model", state)
    sharded = tp.is_sharded(model) or (
        model is not state and state.optimizer.sharded)
    if not logging.is_master_process() and not sharded:
        return None
    model_state = tp.full_state_dict(model)
    optimizer_state = (state.optimizer.state_dict() if model is not state
                       else None)
    if not logging.is_master_process():
        return None
    if async_write is None:
        async_write = bool(getattr(cfg.TPU, "ASYNC_CHECKPOINT", False))
    d = get_checkpoint_dir(path_to_job)
    os.makedirs(d, exist_ok=True)
    if name is not None:
        path = os.path.join(d, name + fmt)
    else:
        path = get_path_to_checkpoint(path_to_job, epoch, fmt)
    payload = {
        "model_state": _host_copy(model_state),
        "epoch": epoch,
        "cfg": cfg.dump() if hasattr(cfg, "dump") else None,
    }
    if model is not state:
        payload.update({
            "optimizer_state": _host_copy(optimizer_state),
            "step": int(state.step),
            "generator_state": state.generator.get_state(),
        })

    def write():
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        logger.info(f"Saved checkpoint to {path}")

    if not async_write:
        write()
        return path
    prev = _PENDING_SAVES[-1] if _PENDING_SAVES else None

    def chained():
        if prev is not None:
            prev.join()
        write()

    t = threading.Thread(target=chained, daemon=False)
    t.start()
    _PENDING_SAVES.append(t)
    # prune landed writers (keep the tail: it anchors the chain)
    while len(_PENDING_SAVES) > 1 and not _PENDING_SAVES[0].is_alive():
        _PENDING_SAVES.pop(0)
    return path


def wait_for_saves() -> None:
    """Block until every async checkpoint write has landed."""
    while _PENDING_SAVES:
        _PENDING_SAVES.pop().join()


def _is_jax_checkpoint(path: str) -> bool:
    """Whether ``path`` holds the JAX package's checkpoint (a pickled dict
    with the msgpack ``state``) rather than a torch file (a zip archive or
    a legacy torch pickle)."""
    with open(path, "rb") as f:
        if f.read(2) == b"PK":
            return False
    with open(path, "rb") as f:
        try:
            payload = pickle.load(f)
        except Exception:  # noqa: BLE001 (not a plain pickle: torch's own)
            return False
    return isinstance(payload, dict) and "state" in payload


def read_payload(path: str):
    """The object a ``.pyth`` / ``.pt`` file holds, on the CPU, after every
    checkpoint write in flight; raises on the JAX package's own format."""
    wait_for_saves()  # in-process read-after-async-write ordering
    if _is_jax_checkpoint(path):
        raise NotImplementedError(
            f"{path} is a JAX-package checkpoint (a flax msgpack train state "
            "under 'state'); the PyTorch port reads torch .pyth / .pt "
            "state dicts only"
        )
    return torch.load(path, map_location="cpu", weights_only=False)


def load_state_dict_file(path: str, payload=None) -> Dict[str, torch.Tensor]:
    """The torch state dict of a ``.pyth`` / ``.pt`` file (or of its
    ``payload``, read already), ``module.`` stripped; raises on the JAX
    package's own format."""
    if payload is None:
        payload = read_payload(path)
    if isinstance(payload, dict):
        for key in ("model_state", "state_dict", "model"):
            if key in payload:
                payload = payload[key]
                break
    return {
        k.replace("module.", "", 1) if k.startswith("module.") else k:
            torch.as_tensor(v)
        for k, v in payload.items()
    }


def apply_name_patterns(sd, clear_patterns=(), replace_patterns=()):
    """TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN / REPLACE_NAME_PATTERN."""
    out = {}
    for k, v in sd.items():
        for pat in clear_patterns:
            k = k.replace(pat, "")
        for src, dst in replace_patterns:
            k = k.replace(src, dst)
        out[k] = v
    return out


def inflate_2d_to_3d(sd, model_sd):
    """2D -> 3D kernel inflation: a [O, I, kh, kw] kernel whose model
    tensor is 3D is tiled along time and divided by the temporal extent."""
    out = dict(sd)
    for name, want in model_sd.items():
        if want.ndim == 5 and name in sd and sd[name].ndim == 4:
            kt = want.shape[2]
            out[name] = sd[name][:, :, None].repeat(1, 1, kt, 1, 1) / float(kt)
    return out


def merge_split_qkv(sd):
    """SPLIT_QKV_CHECKPOINT: q / k / v stored apart are fused back to qkv."""
    out = dict(sd)
    for k in list(sd):
        if k.endswith(".q.weight"):
            base = k[: -len(".q.weight")]
            out[base + ".qkv.weight"] = torch.cat(
                [sd[f"{base}.{x}.weight"] for x in "qkv"], dim=0)
            if f"{base}.q.bias" in sd:
                out[base + ".qkv.bias"] = torch.cat(
                    [sd[f"{base}.{x}.bias"] for x in "qkv"], dim=0)
    return out


def copy_backbone_attn_to_orvit(sd):
    """ORVIT.LOAD_ORVIT_ATTN_LAYERS_FROM_BB: every backbone ``blocks.*qkv*``
    tensor is also offered under the ``orvit_`` prefix, so residually added
    ORViT blocks take their attention from the backbone block at the same
    depth."""
    out = dict(sd)
    for k, v in sd.items():
        if k.startswith("blocks") and "qkv" in k:
            out.setdefault(f"orvit_{k}", v)
    return out


@torch.no_grad()
def import_state_dict(sd, model: torch.nn.Module, split_qkv: bool = False,
                      orvit_attn_from_backbone: bool = False,
                      inflate: bool = False) -> dict:
    """Copy the checkpoint's tensors into ``model`` by name (each cast to
    the model's dtype); returns {"loaded", "missing", "unused"} names."""
    model_sd = model.state_dict()
    if inflate:
        sd = inflate_2d_to_3d(sd, model_sd)
    if split_qkv:
        sd = merge_split_qkv(sd)
    if orvit_attn_from_backbone:
        sd = copy_backbone_attn_to_orvit(sd)
    loaded, missing = [], []
    for name, target in model_sd.items():
        if name in sd:
            src = sd[name]
            if tuple(src.shape) != tuple(target.shape):  # a full leaf
                src = tp.local_tensor(model, name, src)
            if tuple(src.shape) == tuple(target.shape):
                target.copy_(src)
                loaded.append(name)
                continue
            logger.warning(f"Shape mismatch for {name}: shape "
                           f"{tuple(src.shape)} vs target {tuple(target.shape)}")
        missing.append(name)
    used = set(loaded)
    unused = [k for k in sd if k not in used]
    if missing:
        logger.warning(f"{len(missing)} params not found in checkpoint: "
                       f"{missing[:8]}...")
    logger.info(f"torch import: {len(loaded)} loaded, {len(missing)} missing, "
                f"{len(unused)} unused")
    return {"loaded": loaded, "missing": missing, "unused": unused}


def load_checkpoint(path: str, model: torch.nn.Module, cfg,
                    payload=None) -> dict:
    """Load the checkpoint at ``path`` (or its ``payload``, read already)
    into ``model`` under ``cfg``'s naming options; returns the report of
    ``import_state_dict`` with the path."""
    sd = load_state_dict_file(path, payload)
    sd = apply_name_patterns(
        sd,
        clear_patterns=tuple(cfg.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN or ()),
        replace_patterns=tuple(cfg.TRAIN.CHECKPOINT_REPLACE_NAME_PATTERN or ()),
    )
    report = import_state_dict(
        sd, model,
        split_qkv=bool(getattr(cfg, "SPLIT_QKV_CHECKPOINT", False)),
        orvit_attn_from_backbone=bool(
            cfg.ORVIT.ENABLE and cfg.ORVIT.LOAD_ORVIT_ATTN_LAYERS_FROM_BB),
        inflate=bool(cfg.TRAIN.CHECKPOINT_INFLATE),
    )
    logger.info(f"Loaded checkpoint from {path}")
    return {"path": path, **report}


def load_test_checkpoint(cfg, model: torch.nn.Module) -> Optional[dict]:
    """The test path's fallback chain: the numbered epoch
    (TEST.TEST_EPOCH_NUM) -> TEST.CHECKPOINT_FILE_PATH -> the last
    checkpoint in OUTPUT_DIR -> in EXP.PATH -> TRAIN.CHECKPOINT_FILE_PATH ->
    the random initialisation (returns None). Otherwise returns the load's
    report."""
    exp_path = cfg.EXP.PATH if hasattr(cfg, "EXP") else ""
    if int(getattr(cfg.TEST, "TEST_EPOCH_NUM", 0) or 0) > 0:
        n = int(cfg.TEST.TEST_EPOCH_NUM)
        candidates = [
            get_path_to_checkpoint(base, n)
            for base in (cfg.OUTPUT_DIR, exp_path)
            if base
        ]
        path = next((c for c in candidates if os.path.exists(c)), None)
        if path is None:
            raise FileNotFoundError(
                f"TEST.TEST_EPOCH_NUM={n}: none of {candidates} exist"
            )
    elif cfg.TEST.CHECKPOINT_FILE_PATH:
        path = cfg.TEST.CHECKPOINT_FILE_PATH
    elif has_checkpoint(cfg.OUTPUT_DIR):
        path = get_last_checkpoint(cfg.OUTPUT_DIR)
    elif exp_path and has_checkpoint(exp_path):
        path = get_last_checkpoint(exp_path)
    elif cfg.TRAIN.CHECKPOINT_FILE_PATH:
        path = cfg.TRAIN.CHECKPOINT_FILE_PATH
    else:
        logger.info("Testing with random initialization. Only for debugging.")
        return None
    if cfg.TEST.CHECKPOINT_TYPE == "caffe2":
        raise NotImplementedError(
            f"{path}: Caffe2 checkpoints (TEST.CHECKPOINT_TYPE caffe2) are "
            "not read by the PyTorch port yet"
        )
    return load_checkpoint(path, model, cfg)


def is_train_state(payload) -> bool:
    """Whether a checkpoint's payload is the train loop's whole state."""
    return isinstance(payload, dict) and all(k in payload
                                             for k in TRAIN_STATE_KEYS)


def restore_train_state(payload, state) -> int:
    """Load a train-state payload into ``state``: the weights (every name,
    strictly), the optimizer's state, the step and the generator's state.
    Returns the checkpoint's epoch."""
    tp.load_full_state_dict(state.model, payload["model_state"])
    state.optimizer.load_state_dict(payload["optimizer_state"])
    state.step = int(payload["step"])
    state.generator.set_state(payload["generator_state"])
    return int(payload["epoch"])


def load_train_state(path: str, state) -> int:
    """Resume ``state`` from the train checkpoint at ``path``; returns its
    epoch."""
    payload = read_payload(path)
    if not is_train_state(payload):
        raise ValueError(f"{path} holds no train state (its keys: "
                         f"{sorted(payload) if isinstance(payload, dict) else type(payload)})")
    epoch = restore_train_state(payload, state)
    logger.info(f"Loaded checkpoint from {path} (epoch {epoch}, step "
                f"{state.step})")
    return epoch


def load_train_checkpoint(cfg, state, path_to_job: Optional[str] = None):
    """The train loop's start (reference checkpoint.py:544-584): under
    TRAIN.AUTO_RESUME the last checkpoint in ``path_to_job`` (default
    OUTPUT_DIR), whole, at its epoch; else TRAIN.CHECKPOINT_FILE_PATH: the port's own train
    checkpoint whole, at its epoch (0 under TRAIN.CHECKPOINT_EPOCH_RESET),
    or any other ``.pyth`` / ``.pt`` as weights alone through
    ``import_state_dict`` at epoch 0; else the initialisation at epoch 0.
    A missing file raises, as do Caffe2 and JAX-package checkpoints.
    Returns (start epoch, report: the path, "kind" resume / train_state /
    weights, the import's names for weights; None where nothing loads)."""
    job = path_to_job or cfg.OUTPUT_DIR
    if cfg.TRAIN.AUTO_RESUME and has_checkpoint(job):
        path = get_last_checkpoint(job)
        return load_train_state(path, state), {"path": path, "kind": "resume"}
    path = cfg.TRAIN.CHECKPOINT_FILE_PATH
    if not path:
        return 0, None
    if cfg.TRAIN.CHECKPOINT_TYPE == "caffe2":
        raise NotImplementedError(
            f"{path}: Caffe2 checkpoints (TRAIN.CHECKPOINT_TYPE caffe2) are "
            "not read by the PyTorch port yet"
        )
    if not os.path.exists(path):
        raise FileNotFoundError(f"TRAIN.CHECKPOINT_FILE_PATH {path} does not "
                                "exist")
    payload = read_payload(path)
    if is_train_state(payload):
        epoch = restore_train_state(payload, state)
        logger.info(f"Loaded train state from {path} (epoch {epoch})")
        if cfg.TRAIN.CHECKPOINT_EPOCH_RESET:
            epoch = 0
        return epoch, {"path": path, "kind": "train_state"}
    report = load_checkpoint(path, state.model, cfg, payload)
    return 0, {"kind": "weights", **report}
