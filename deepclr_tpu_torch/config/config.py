"""Schema'd hierarchical configuration tree.

Declared parameters with defaults / required / internal flags, nested groups
with attribute access, freeze/defrost, optional dynamic (undeclared)
parameters, dotted-path overrides, and YAML round-tripping (enums serialized
by value).  PyYAML is imported only by the methods that read or write YAML,
so a tree built with ``read_dict`` needs no YAML package.
"""
from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["Config", "ConfigParam"]


class ConfigParam:
    """A declared parameter: default value, required/internal flags."""

    def __init__(self, default: Any = None, required: bool = False,
                 internal: bool = False):
        self.default = default
        self.required = required
        self.internal = internal
        self.value = default
        self.was_set = default is not None

    def set(self, value: Any) -> None:
        self.value = value
        self.was_set = True

    @property
    def valid(self) -> bool:
        return not self.required or self.was_set


class Config:
    """Ordered attribute-dict of parameters and sub-groups."""

    _RESERVED = {"_params", "_groups", "_frozen", "_allow_dynamic"}

    def __init__(self, allow_dynamic_params: bool = False):
        object.__setattr__(self, "_params", {})
        object.__setattr__(self, "_groups", {})
        object.__setattr__(self, "_frozen", False)
        object.__setattr__(self, "_allow_dynamic", allow_dynamic_params)

    # --- schema declaration --------------------------------------------------
    def define_param(self, name: str, parent: Optional["Config"] = None,
                     default: Any = None, required: bool = False) -> None:
        target = parent if parent is not None else self
        target._params[name] = ConfigParam(default=default, required=required)

    def add_internal_param(self, name: str, value: Any = None,
                           parent: Optional["Config"] = None) -> None:
        target = parent if parent is not None else self
        p = ConfigParam(internal=True)
        p.value = value
        p.was_set = True
        target._params[name] = p

    def define_group(self, name: str, parent: Optional["Config"] = None) -> "Config":
        target = parent if parent is not None else self
        grp = Config(allow_dynamic_params=target._allow_dynamic)
        target._groups[name] = grp
        return grp

    # --- attribute access ----------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        params = object.__getattribute__(self, "_params")
        groups = object.__getattribute__(self, "_groups")
        if name in params:
            return params[name].value
        if name in groups:
            return groups[name]
        raise AttributeError(f"Unknown config parameter '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        if name in self._RESERVED:
            object.__setattr__(self, name, value)
            return
        if self._frozen:
            raise RuntimeError(f"Config is frozen; cannot set '{name}'")
        if name in self._params:
            self._params[name].set(value)
        elif name in self._groups:
            raise RuntimeError(f"Cannot overwrite config group '{name}'")
        elif self._allow_dynamic:
            p = ConfigParam()
            p.set(value)
            self._params[name] = p
        else:
            raise RuntimeError(f"Unknown config parameter '{name}'")

    def __contains__(self, name: str) -> bool:
        return name in self._params or name in self._groups

    def __iter__(self):
        yield from self._params
        yield from self._groups

    # --- freeze --------------------------------------------------------------
    def freeze(self) -> None:
        object.__setattr__(self, "_frozen", True)
        for g in self._groups.values():
            g.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, "_frozen", False)
        for g in self._groups.values():
            g.defrost()

    def is_frozen(self) -> bool:
        return self._frozen

    # --- validity ------------------------------------------------------------
    def is_valid(self) -> bool:
        return not self.missing_params()

    def missing_params(self, prefix: str = "") -> List[str]:
        missing = [
            prefix + name for name, p in self._params.items() if not p.valid
        ]
        for gname, g in self._groups.items():
            missing += g.missing_params(prefix + gname + ".")
        return missing

    # --- data I/O ------------------------------------------------------------
    def read_dict(self, d: Dict[str, Any]) -> None:
        """Merge a plain dict into the tree (creating dynamic params/groups)."""
        for key, value in d.items():
            if isinstance(value, dict) and not key.endswith("params"):
                if key in self._params:
                    # declared as a param but given a mapping: store verbatim
                    self._params[key].set(value)
                    continue
                if key not in self._groups:
                    if not self._allow_dynamic:
                        raise RuntimeError(f"Unknown config group '{key}'")
                    self.define_group(key)
                self._groups[key].read_dict(value)
            else:
                # "...params" subtrees are stored as plain dicts (factory
                # kwargs stay opaque)
                if key in self._groups:
                    if isinstance(value, dict):
                        self._groups[key].read_dict(value)
                        continue
                    raise RuntimeError(f"Cannot assign scalar to group '{key}'")
                if key in self._params:
                    self._params[key].set(value)
                elif self._allow_dynamic:
                    p = ConfigParam()
                    p.set(value)
                    self._params[key] = p
                else:
                    raise RuntimeError(f"Unknown config parameter '{key}'")

    def read_file(self, filename: str) -> None:
        import yaml

        with open(filename, "r") as f:
            d = yaml.load(f, Loader=yaml.Loader)
        if d:
            self.read_dict(d)

    def read_list(self, items: List[str]) -> None:
        """Apply dotted-path overrides: ['optimizer.base_lr', '1e-4', ...]."""
        import yaml

        if len(items) % 2 != 0:
            raise RuntimeError("Override list must be key/value pairs")
        for key, value in zip(items[::2], items[1::2]):
            node = self
            parts = key.split(".")
            for part in parts[:-1]:
                node = getattr(node, part)
            try:
                parsed = yaml.safe_load(value)
            except yaml.YAMLError:
                parsed = value
            setattr(node, parts[-1], parsed)

    def to_dict(self, include_internal: bool = True) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, p in self._params.items():
            if p.internal and not include_internal:
                continue
            out[name] = _plain(p.value)
        for name, g in self._groups.items():
            out[name] = g.to_dict(include_internal=include_internal)
        return out

    def write_file(self, filename: str, include_internal: bool = True) -> None:
        import yaml

        with open(filename, "w") as f:
            yaml.dump(
                self.to_dict(include_internal=include_internal),
                f,
                default_flow_style=False,
                sort_keys=False,
            )

    def __repr__(self) -> str:  # pragma: no cover
        return f"Config({self.to_dict()})"


def _plain(value: Any) -> Any:
    """Convert enums / nested structures to YAML-safe plain values."""
    if isinstance(value, enum.Enum):
        return value.value if isinstance(value.value, str) else value.name.lower()
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.integer):
        return int(value)
    return value
