"""Path helpers: environment-variable and ``~`` expansion that fails loudly."""
from __future__ import annotations

import os
import re

__all__ = ["expand_path"]

_ENV_RE = re.compile(r"\$\{?(\w+)\}?")


def expand_path(path):
    """Expand environment variables and ~; error on unresolved variables.

    Accepts a single path, None, or a list of paths (mapped elementwise).
    """
    if path is None:
        return None
    if isinstance(path, (list, tuple)):
        return [expand_path(p) for p in path]
    expanded = os.path.expanduser(os.path.expandvars(str(path)))
    m = _ENV_RE.search(expanded)
    if m:
        raise RuntimeError(
            f"Could not resolve environment variable '{m.group(1)}' in path '{path}'"
        )
    return expanded
