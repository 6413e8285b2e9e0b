"""Pairwise squared distances, the workhorse behind kNN."""
from __future__ import annotations

import torch

__all__ = ["pairwise_sqdist"]


def _sqnorm(x: torch.Tensor) -> torch.Tensor:
    # an explicit left-to-right sum: a reduction kernel may add in another order
    out = x[..., 0] * x[..., 0]
    for k in range(1, x.shape[-1]):
        out = out + x[..., k] * x[..., k]
    return out


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (..., N, D) x (..., M, D) -> (..., N, M).

    Expanded form ||a||² + ||b||² − 2·a·bᵀ in float32, clamped at 0 (the
    expanded form can go slightly negative).  The cross term is a matmul;
    it must run with TF32 off (``device.strict_float32``), since the
    distances feed neighbour selection.
    """
    a = a.float()
    b = b.float()
    cross = torch.matmul(a, b.transpose(-1, -2))
    d2 = _sqnorm(a)[..., :, None] + _sqnorm(b)[..., None, :] - 2.0 * cross
    return torch.clamp_min(d2, 0.0)
