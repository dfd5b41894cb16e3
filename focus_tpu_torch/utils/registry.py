"""String-keyed registries (counterpart of ``focus_tpu/utils/registry.py``,
which replaces the fvcore ``Registry`` of the reference)."""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._map: Dict[str, Any] = {}

    def register(self, obj: Optional[Any] = None, name: Optional[str] = None):
        """Use as ``@REG.register()`` decorator or direct ``REG.register(obj)``."""
        if obj is None:

            def deco(fn_or_cls: Any) -> Any:
                self._do_register(name or fn_or_cls.__name__, fn_or_cls)
                return fn_or_cls

            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def _do_register(self, name: str, obj: Any) -> None:
        if name in self._map:
            raise KeyError(f"'{name}' already registered in {self._name} registry")
        self._map[name] = obj

    def get(self, name: str) -> Any:
        if name not in self._map:
            raise KeyError(
                f"'{name}' not found in {self._name} registry. "
                f"Available: {sorted(self._map)}"
            )
        return self._map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def __iter__(self) -> Iterator:
        return iter(self._map.items())

    def keys(self):
        return self._map.keys()
