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
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import torch

from focus_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

CKPT_DIR = "checkpoints"


def get_checkpoint_dir(path_to_job: str) -> str:
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


def save_checkpoint(path_to_job: str, model: torch.nn.Module, epoch: int, cfg,
                    name: Optional[str] = None, fmt: str = ".pyth"
                    ) -> Optional[str]:
    """Write ``model``'s state (on the CPU) to the epoch's checkpoint, or to
    ``name + fmt`` in the checkpoint directory; rank 0 alone writes, through
    a ``.tmp`` file renamed into place. Returns the path."""
    if not logging.is_master_process():
        return None
    d = get_checkpoint_dir(path_to_job)
    os.makedirs(d, exist_ok=True)
    if name is not None:
        path = os.path.join(d, name + fmt)
    else:
        path = get_path_to_checkpoint(path_to_job, epoch, fmt)
    payload = {
        "model_state": {k: v.detach().cpu()
                        for k, v in model.state_dict().items()},
        "epoch": epoch,
        "cfg": cfg.dump() if hasattr(cfg, "dump") else None,
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    logger.info(f"Saved checkpoint to {path}")
    return path


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


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """The torch state dict of a ``.pyth`` / ``.pt`` file, ``module.``
    stripped; raises on the JAX package's own format."""
    if _is_jax_checkpoint(path):
        raise NotImplementedError(
            f"{path} is a JAX-package checkpoint (a flax msgpack train state "
            "under 'state'); the PyTorch port reads torch .pyth / .pt "
            "state dicts only"
        )
    payload = torch.load(path, map_location="cpu", weights_only=False)
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


def load_checkpoint(path: str, model: torch.nn.Module, cfg) -> dict:
    """Load the checkpoint at ``path`` into ``model`` under ``cfg``'s
    naming options; returns the report of ``import_state_dict`` with the
    path."""
    sd = load_state_dict_file(path)
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
