"""A minimal, dependency-free configuration node.

Drop-in replacement for the yacs/fvcore ``CfgNode`` surface that the
reference framework exposes (see reference ``slowfast/config/defaults.py``
which builds on ``fvcore.common.config.CfgNode``).  We only implement the
operations the framework actually uses:

* attribute-style access (``cfg.TRAIN.BATCH_SIZE``)
* ``clone()``
* ``merge_from_file(yaml_path)`` — YAML values override defaults
* ``merge_from_list(["KEY.SUBKEY", value, ...])`` — CLI ``opts`` override
* ``dump()`` — YAML serialisation (for checkpoint metadata)
* ``freeze()`` / ``defrost()`` — mutation guard

Values are type-checked against the default on merge, with the same
coercions yacs performs (list<->tuple, int->float, str literal eval).
"""

from __future__ import annotations

import ast
import copy
from typing import Any

import yaml

_VALID_TYPES = (int, float, bool, str, type(None), list, tuple)


class CfgNode(dict):
    """Nested attribute dict with yacs-compatible merge semantics."""

    IMMUTABLE = "__immutable__"
    NEW_ALLOWED = "__new_allowed__"

    def __init__(self, init_dict=None, new_allowed=False):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        object.__setattr__(self, CfgNode.NEW_ALLOWED, new_allowed)
        for k, v in init_dict.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                v = CfgNode(v, new_allowed=new_allowed)
            dict.__setitem__(self, k, v)

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(
                f"Config key '{name}' not found. Known keys: {sorted(self.keys())[:20]}"
            )

    def __setattr__(self, name: str, value: Any) -> None:
        if name in (CfgNode.IMMUTABLE, CfgNode.NEW_ALLOWED):
            object.__setattr__(self, name, value)
            return
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if getattr(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"CfgNode is frozen; cannot set '{name}'")
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            value = CfgNode(value)
        dict.__setitem__(self, name, value)

    # -- lifecycle ---------------------------------------------------------
    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        out = CfgNode()
        memo[id(self)] = out
        for k, v in self.items():
            dict.__setitem__(out, k, copy.deepcopy(v, memo))
        return out

    def __reduce__(self):
        """Pickled as its items (the processes that
        ``tools.run_net.launch_job`` spawns receive the config)."""
        return (CfgNode, (dict(self), getattr(self, CfgNode.NEW_ALLOWED)))

    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return getattr(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, flag: bool) -> None:
        object.__setattr__(self, CfgNode.IMMUTABLE, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(flag)

    # -- merging -----------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge_into(other, self, [])

    def merge_from_file(self, path: str, allow_unsafe: bool = True) -> None:
        with open(path) as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        _merge_into(CfgNode(loaded), self, [])

    def merge_from_list(self, opts) -> None:
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for full_key, v in zip(opts[0::2], opts[1::2]):
            keys = full_key.split(".")
            node = self
            for k in keys[:-1]:
                if k not in node:
                    raise KeyError(f"Non-existent config key: {full_key}")
                node = node[k]
            leaf = keys[-1]
            if leaf not in node and not getattr(node, CfgNode.NEW_ALLOWED):
                raise KeyError(f"Non-existent config key: {full_key}")
            default = node.get(leaf, None)
            node[leaf] = _coerce(_decode(v), default, full_key)

    # -- serialisation -------------------------------------------------------
    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else v
        return out

    def dump(self, **kwargs) -> str:
        return yaml.safe_dump(self.to_dict(), **kwargs)

    def __str__(self) -> str:
        return self.dump()

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"


class StaticCfg:
    """Opaque, hashable wrapper so a CfgNode can be a flax Module attribute
    (flax would otherwise coerce the dict subclass into a FrozenDict).
    Attribute access proxies to the wrapped node; nested nodes are wrapped
    on the fly. Hash/eq use the YAML dump so jit treats equal configs as
    the same static value."""

    __slots__ = ("_node", "_dump")

    def __init__(self, node: "CfgNode"):
        object.__setattr__(self, "_node", node)
        object.__setattr__(self, "_dump", None)

    def __getattr__(self, name: str) -> Any:
        v = getattr(object.__getattribute__(self, "_node"), name)
        return StaticCfg(v) if isinstance(v, CfgNode) else v

    def __setattr__(self, name, value):
        raise AttributeError("StaticCfg is read-only")

    def unwrap(self) -> "CfgNode":
        return object.__getattribute__(self, "_node")

    def _key(self) -> str:
        d = object.__getattribute__(self, "_dump")
        if d is None:
            d = object.__getattribute__(self, "_node").dump()
            object.__setattr__(self, "_dump", d)
        return d

    def __hash__(self) -> int:
        return hash(self._key())

    def __eq__(self, other) -> bool:
        return isinstance(other, StaticCfg) and self._key() == other._key()

    def __repr__(self) -> str:
        return "StaticCfg(...)"


def _decode(v: Any) -> Any:
    """Decode a YAML/CLI string into a python literal when possible."""
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _coerce(value: Any, default: Any, full_key: str) -> Any:
    """yacs-style type reconciliation of an override against the default."""
    if default is None or value is None:
        return value
    if type(value) is type(default):
        return value
    casts = [(tuple, list), (list, tuple), (int, float)]
    for src, dst in casts:
        if isinstance(value, src) and isinstance(default, dst):
            return dst(value)
    if isinstance(default, bool) and isinstance(value, str):
        low = value.lower()
        if low in ("true", "false"):
            return low == "true"
    if isinstance(default, (int, float)) and isinstance(value, bool):
        return value
    raise ValueError(
        f"Type mismatch for key {full_key}: override {type(value).__name__}"
        f" vs default {type(default).__name__}"
    )


def _merge_into(src: CfgNode, dst: CfgNode, path: list) -> None:
    for k, v in src.items():
        full_key = ".".join(path + [k])
        if k not in dst:
            if getattr(dst, CfgNode.NEW_ALLOWED):
                dst[k] = v
                continue
            raise KeyError(f"Non-existent config key: {full_key}")
        if isinstance(v, CfgNode) and isinstance(dst[k], CfgNode):
            _merge_into(v, dst[k], path + [k])
        else:
            dst[k] = _coerce(_decode(v), dst[k], full_key)
