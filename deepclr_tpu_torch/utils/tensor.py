"""Device transfer of nested containers (the JAX package's
``utils/tensor.py``)."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["prepare_tensor"]


def prepare_tensor(x: Any, device: Any = None) -> Any:
    """Move a tensor or numpy array, or every one in a nested dict / list /
    tuple, to ``device`` (a numpy array becomes a tensor); anything else
    passes through unchanged."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x).to(device)
    if isinstance(x, dict):
        return {k: prepare_tensor(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(prepare_tensor(v, device) for v in x)
    return x
