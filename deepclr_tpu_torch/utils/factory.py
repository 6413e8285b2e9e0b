"""Recursive subclass factory-by-name (the JAX package's
``utils/factory.py``).

The model registry (models/build.py) is the primary construction path; this
generic helper exists for user-defined module hierarchies.
"""
from __future__ import annotations

from typing import Any, Type, TypeVar

T = TypeVar("T")

__all__ = ["factory"]


def _find_subclass(base: Type, name: str):
    for cls in base.__subclasses__():
        if cls.__name__ == name:
            return cls
        found = _find_subclass(cls, name)
        if found is not None:
            return found
    return None


def factory(base: Type[T], name: str, *args: Any, **kwargs: Any) -> T:
    """Instantiate the subclass of ``base`` whose class name is ``name``."""
    if base.__name__ == name:
        return base(*args, **kwargs)
    cls = _find_subclass(base, name)
    if cls is None:
        raise ValueError(
            f"No subclass '{name}' of {base.__name__} found"
        )
    return cls(*args, **kwargs)
