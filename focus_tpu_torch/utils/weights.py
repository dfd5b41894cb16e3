"""Carry JAX-package parameters across to the port.

``jax_params_to_state_dict`` turns the JAX package's Motionformer/ORViT
params (a nested dict of numpy arrays, as ``model.init(...)["params"]``
gives after ``jax.device_get``) into the port's ``state_dict``. It keeps
its own copy of the Motionformer/ORViT subset of the naming and layout
rules of ``focus_tpu/utils/torch_import.py``:

- Dense kernel ``[in, out]`` -> ``weight [out, in]``;
- Conv3d kernel ``[kt, kh, kw, C, D]`` -> ``weight [D, C, kt, kh, kw]``;
- LayerNorm ``scale`` -> ``weight``;
- ``patch_to_d`` / ``c_coord_to_feature`` ``fc1``/``fc2`` -> ``0``/``2``;
- ``pre_logits_fc`` -> ``pre_logits.fc``; ``blocks_{i}`` -> ``blocks.{i}``;
- a scanned stack ``blocks_{a}_{b}/body/...`` (leading layer axis) is
  unstacked into ``blocks.{a+j}.*``.

``load_jax_params`` loads the result with missing, unexpected or
mis-shaped keys reported as errors.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

_SEQ_MLPS = ("patch_to_d", "c_coord_to_feature")
_SCANNED = re.compile(r"^blocks_(\d+)_(\d+)$")


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _torch_name(path: Tuple[str, ...]) -> Tuple[str, str]:
    """(torch name, leaf kind) of one flax param path."""
    parts = []
    for m in path[:-1]:
        prev = parts[-1] if parts else None
        if m.startswith("blocks_"):
            parts.append("blocks." + m[len("blocks_"):])
        elif m == "pre_logits_fc":
            parts.append("pre_logits.fc")
        elif m in ("fc1", "fc2") and prev in _SEQ_MLPS:
            parts.append("0" if m == "fc1" else "2")
        else:
            parts.append(m)
    leaf = path[-1]
    if leaf in ("kernel", "scale"):
        return ".".join(parts + ["weight"]), leaf
    return ".".join(parts + [leaf]), "raw"


def _to_torch(arr: np.ndarray, kind: str) -> torch.Tensor:
    if kind == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 5:  # [kt, kh, kw, C, D] -> [D, C, kt, kh, kw]
            arr = arr.transpose(4, 3, 0, 1, 2)
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def jax_params_to_state_dict(params) -> Dict[str, torch.Tensor]:
    """JAX Motionformer/ORViT params -> the port's state_dict (CPU, f32)."""
    sd = {}
    for path, arr in _flatten(params).items():
        m = _SCANNED.match(path[0])
        if m is None:
            layers = [(path, arr)]
        else:
            a = int(m.group(1))
            sub = tuple(p for p in path[1:] if p != "body")
            layers = [((f"blocks_{a + j}",) + sub, arr[j])
                      for j in range(arr.shape[0])]
        for p, a_ in layers:
            name, kind = _torch_name(p)
            if name in sd:
                raise KeyError(f"two JAX params map to {name}")
            sd[name] = _to_torch(a_, kind)
    return sd


def load_jax_params(model: torch.nn.Module, params) -> Dict[str, torch.Tensor]:
    """Load JAX params into ``model``; missing, unexpected or mis-shaped
    keys raise. Returns the converted state_dict."""
    sd = jax_params_to_state_dict(params)
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    unexpected = sorted(set(sd) - set(want))
    if missing or unexpected:
        raise KeyError(f"missing keys {missing}; unexpected keys {unexpected}")
    bad = [f"{k}: {tuple(sd[k].shape)} vs {tuple(want[k].shape)}"
           for k in sd if sd[k].shape != want[k].shape]
    if bad:
        raise ValueError(f"shape mismatches: {bad}")
    model.load_state_dict(sd, strict=True)
    return sd
