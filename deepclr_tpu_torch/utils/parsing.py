"""argparse helpers (the JAX package's ``utils/parsing.py``)."""
from __future__ import annotations

import argparse
import enum
from typing import Any, Type

__all__ = ["ParseEnum"]


class ParseEnum(argparse.Action):
    """Parse a string into an Enum member (by value, case-insensitive)."""

    def __init__(self, option_strings, dest, enum_type: Type[enum.Enum] = None,
                 **kwargs: Any):
        if enum_type is None:
            raise ValueError("enum_type required")
        self._enum_type = enum_type
        kwargs.setdefault("choices", [e.value for e in enum_type])
        super().__init__(option_strings, dest, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, self._enum_type(str(values).lower()))
