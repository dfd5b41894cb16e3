"""Carry JAX-package parameters across to the port.

``jax_params_to_state_dict`` turns the JAX package's params (a nested dict
of numpy arrays, as ``model.init(...)["params"]`` gives after
``jax.device_get``) into the port's ``state_dict``. It keeps its own copy
of the naming and layout rules of ``focus_tpu/utils/torch_import.py`` for
the models ported so far (Motionformer/ORViT, STEVE, the ResNet family,
MViT):

- Dense kernel ``[in, out]`` -> ``weight [out, in]``; the STEVE ``Dense``
  wrapper's inner ``linear`` has no torch name;
- Conv3d kernel ``[kt, kh, kw, C, D]`` -> ``weight [D, C, kt, kh, kw]``;
  Conv2d kernel ``[kh, kw, I, O]`` -> ``weight [O, I, kh, kw]``; a
  ``Conv2dBlock``'s inner ``conv`` is attribute ``m``;
- the ``ConvTranspose`` kernel of ``upconv`` ``[kh, kw, I, O]`` ->
  ``weight [I, O, kh, kw]`` flipped in both spatial axes (flax does not
  flip its kernel, ``torch.nn.ConvTranspose2d`` does); a grouped or
  depthwise kernel ``[kt, kh, kw, C/g, D]`` -> ``[D, C/g, kt, kh, kw]``, the
  same transpose;
- LayerNorm / BatchNorm ``scale`` -> ``weight``; Embed ``embedding`` ->
  ``weight``; the GRU's ``weight_ih`` / ``weight_hh`` transposed;
- ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` / ``running_var``;
  the conv family's BatchNorm module wraps flax's, also named ``bn``, and
  that inner name has no torch counterpart (``a_bn/bn/scale`` ->
  ``a_bn.weight``);
- ``patch_to_d`` / ``c_coord_to_feature`` / ``ffn`` ``fc1``/``fc2`` ->
  ``0``/``2``; ``mlp_fc1``/``mlp_fc2`` -> ``mlp.0``/``mlp.2``; ``dict`` ->
  ``dict.dictionary``; the dVAE and BaseCNN stages -> their
  ``nn.Sequential`` slots;
- ``pre_logits_fc`` -> ``pre_logits.fc``; ``blocks_{i}`` -> ``blocks.{i}``,
  ``orvit_blocks_{i}`` -> ``orvit_blocks.{i}``; ``patch_embed_proj`` ->
  ``patch_embed.proj``; MViT's ``pool_q/pool`` -> ``pool_q`` and
  ``pool_q/norm`` -> ``norm_q`` (and k, v; the depthwise kernel
  ``[kt, kh, kw, 1, C]`` transposed as every Conv3d kernel);
- a scanned stack ``blocks_{a}_{b}/body/...`` (leading layer axis) is
  unstacked into ``blocks.{a+j}.*``;
- a MoE MLP's router is a Dense (``mlp/router/kernel`` ->
  ``mlp.router.weight``, transposed) and its stacked experts
  (``mlp/experts/{kernel1,bias1,kernel2,bias2}``) keep their layout and
  names.

``load_jax_params`` loads the result with missing, unexpected or
mis-shaped keys reported as errors; BatchNorm ``batch_stats`` (``mean``,
``var``) load beside the params as the running statistics, and the
model's ``num_batches_tracked`` (which nothing reads) is accepted and
ignored. ``load_jax_adam_state`` carries an optax Adam state (the slot
train state's ``opt_state``, every group's moments and count) into a
``torch.optim.Adam`` over the same model.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

_SEQ_MLPS = ("patch_to_d", "c_coord_to_feature", "ffn")
_SCANNED = re.compile(r"^blocks_(\d+)_(\d+)$")
_RENAMES = {"pre_logits_fc": "pre_logits.fc", "dict": "dict.dictionary",
            "mlp_fc1": "mlp.0", "mlp_fc2": "mlp.2",
            "patch_embed_proj": "patch_embed.proj"}
# the parts of the JAX MViT's AttentionPool modules, conv ``pool`` and
# LayerNorm ``norm``, sit on the attention module as ``pool_q`` / ``norm_q``
# (and k, v)
_ATTENTION_POOLS = ("pool_q", "pool_k", "pool_v")
# nn.Sequential slots of the dVAE and BaseCNN stages (the gaps are the
# PixelShuffle slots), keyed by the parent module's name
_STAGES = {
    "encoder": {"stem": "0", "head": "7",
                **{f"block_{i}": str(i + 1) for i in range(6)}},
    "decoder": {"in_block": "0", "block_0": "1", "block_1": "2",
                "block_2": "3", "up_proj_0": "4", "block_3": "6",
                "block_4": "7", "block_5": "8", "up_proj_1": "9",
                "head": "11"},
    "cnn": {"block_0": "fenc.0", "block_1": "fenc.1", "block_2": "fenc.2",
            "head": "fenc.3"},
}
# the stages that are a ``Conv2dBlock``, whose inner ``conv`` is ``m``
_CONV_BLOCKS = frozenset(k for table in _STAGES.values() for k in table
                         if k != "head")


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
    mods = path[:-1]
    for i, m in enumerate(mods):
        parent = mods[i - 1] if i else None
        if m == "linear":
            continue
        if m in _STAGES.get(parent, ()):
            parts.append(_STAGES[parent][m])
        elif m.startswith("blocks_"):
            parts.append("blocks." + m[len("blocks_"):])
        elif m.startswith("orvit_blocks_"):
            parts.append("orvit_blocks." + m[len("orvit_blocks_"):])
        elif parent in _ATTENTION_POOLS and m in ("pool", "norm"):
            parts[-1] = parent if m == "pool" else "norm_" + parent[-1]
        elif m in ("fc1", "fc2") and parent in _SEQ_MLPS:
            parts.append("0" if m == "fc1" else "2")
        elif m == "conv" and parent in _CONV_BLOCKS:
            parts.append("m")
        elif m == "bn" and parent is not None and parent.endswith("bn"):
            continue  # the conv family's BatchNorm wraps flax's, "bn"
        else:
            parts.append(_RENAMES.get(m, m))
    leaf = path[-1]
    if leaf == "kernel" and mods and mods[-1] == "upconv":
        return ".".join(parts + ["weight"]), "transposed_conv"
    if leaf in ("kernel", "scale", "embedding"):
        return ".".join(parts + ["weight"]), leaf
    if leaf in ("weight_ih", "weight_hh"):
        return ".".join(parts + [leaf]), "kernel"
    if leaf in ("mean", "var"):  # BatchNorm running statistics
        return ".".join(parts + ["running_" + leaf]), "raw"
    return ".".join(parts + [leaf]), "raw"


def _to_torch(arr: np.ndarray, kind: str) -> torch.Tensor:
    if kind == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:  # [kh, kw, I, O] -> [O, I, kh, kw]
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 5:  # [kt, kh, kw, C, D] -> [D, C, kt, kh, kw]
            arr = arr.transpose(4, 3, 0, 1, 2)
    elif kind == "transposed_conv":  # [kh, kw, I, O] -> [I, O, kh, kw], flipped
        arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
    # float32, or float64 where the JAX value is (an x64 comparison's)
    dtype = np.float64 if arr.dtype == np.float64 else np.float32
    return torch.from_numpy(np.array(arr, dtype=dtype))


def jax_params_to_state_dict(params, under: Tuple[str, ...] = ()
                             ) -> Dict[str, torch.Tensor]:
    """JAX params -> the port's state_dict (CPU, float32; float64 values
    stay float64). ``under`` is the
    module path the tree hangs from in its model, for a sub-module's params
    taken alone (``("dvae",)``, ``("steve_encoder", "cnn")``): the stage
    tables read it, and the names returned do not carry it."""
    sd = {}
    strip = len(_torch_name(tuple(under) + ("_",))[0]) - 1 if under else 0
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
            name, kind = _torch_name(tuple(under) + p)
            name = name[strip:]
            if name in sd:
                raise KeyError(f"two JAX params map to {name}")
            sd[name] = _to_torch(a_, kind)
    return sd


def jax_grads_to_state_dict(grads, under: Tuple[str, ...] = ()
                            ) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree (``jax.grad`` with respect to params) keyed by
    the port's parameter names: it has the params' structure, so it maps as
    they do, transposes and all."""
    return jax_params_to_state_dict(grads, under)


def reference_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference (upstream) ``state_dict`` without the constant buffers
    that the port computes instead of storing: the decoder blocks' causal
    ``self_attn_mask`` and the cartesian grid ``pos.pe`` ([1, 4, H, W])."""
    return {k: v for k, v in sd.items()
            if not (k.endswith("self_attn_mask")
                    or (k.endswith("pos.pe") and v.ndim == 4))}


def load_jax_params(model: torch.nn.Module, params, batch_stats=None,
                    under: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """Load JAX params (and BatchNorm ``batch_stats``) into ``model``;
    missing, unexpected or mis-shaped keys raise. Returns the converted
    state_dict."""
    sd = jax_params_to_state_dict(params, under)
    if batch_stats is not None:
        sd.update(jax_params_to_state_dict(batch_stats, under))
    want = model.state_dict()
    for k, v in want.items():  # torch's own BatchNorm step counter
        if k.endswith("num_batches_tracked"):
            sd.setdefault(k, v)
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


def _adam_states(tree):
    """Every Adam state (a node with ``count``, ``mu`` and ``nu``) of an
    optax state tree taken to the host: clip, partition and mask states are
    tuples and dicts around them."""
    if all(hasattr(tree, a) for a in ("count", "mu", "nu")):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _adam_states(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _adam_states(v)


def _arrays_only(tree):
    """A params-shaped tree without the leaves that are not arrays (optax's
    ``MaskedNode`` stands where a group does not own the parameter)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            sub = _arrays_only(v)
            if sub:
                out[k] = sub
        elif getattr(v, "shape", None) is not None:
            out[k] = v
    return out


@torch.no_grad()
def load_jax_adam_state(optimizer: torch.optim.Optimizer,
                        model: torch.nn.Module, opt_state) -> int:
    """Set ``optimizer``'s state (``torch.optim.Adam`` over ``model``'s
    parameters) from ``opt_state``: each parameter's ``exp_avg`` and
    ``exp_avg_sq`` from its group's ``mu`` and ``nu`` (laid out as the
    params are), ``step`` from its count. A parameter no group owns keeps
    its state. Returns the parameters set."""
    params = dict(model.named_parameters())
    done = set()
    for st in _adam_states(opt_state):
        count = float(np.asarray(st.count))
        mu = jax_params_to_state_dict(_arrays_only(st.mu))
        nu = jax_params_to_state_dict(_arrays_only(st.nu))
        for name, m in mu.items():
            p = params[name]
            optimizer.state[p] = {"step": torch.tensor(count),
                                  "exp_avg": m.to(p.device),
                                  "exp_avg_sq": nu[name].to(p.device)}
            done.add(name)
    return len(done)
