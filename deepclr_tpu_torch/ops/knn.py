"""Batched exact k-nearest-neighbours between two point sets."""
from __future__ import annotations

from typing import Optional

import torch

from .pairwise import pairwise_sqdist

__all__ = ["knn"]

# the distance of a masked reference point, as the JAX package gives it
_FLOAT32_MAX = torch.finfo(torch.float32).max
# up to this k the JAX package selects by k argmin sweeps (above it, top_k)
_SWEEP_MAX_K = 32


def knn(query: torch.Tensor, points: torch.Tensor, k: int, points_mask: Optional[torch.Tensor] = None):
    """For each query point, its k nearest reference points, nearest first.

    query (B, Q, D), points (B, N, D), optional points_mask (B, N) bool ->
    (idx (B, Q, k) int64, sqdist (B, Q, k) float32).  A masked reference
    point lies at float32's largest distance.  Ties go to the lowest index:
    a stable sort keeps equal distances in index order (``torch.topk``
    leaves the order of ties open).  A slot past a row's last valid point
    holds index 0 for k <= 32, as the JAX package's argmin sweeps give it.
    """
    d2 = pairwise_sqdist(query, points)
    if points_mask is not None:
        d2 = torch.where(points_mask[:, None, :], d2, _FLOAT32_MAX)
    sqdist, idx = torch.sort(d2, dim=-1, stable=True)
    idx, sqdist = idx[..., :k], sqdist[..., :k]
    if points_mask is not None and k <= _SWEEP_MAX_K:
        idx = torch.where(sqdist == _FLOAT32_MAX, 0, idx)
    return idx, sqdist
