"""Batched exact k-nearest-neighbours between two point sets."""
from __future__ import annotations

import torch

from .pairwise import pairwise_sqdist

__all__ = ["knn"]


def knn(query: torch.Tensor, points: torch.Tensor, k: int):
    """For each query point, its k nearest reference points, nearest first.

    query (B, Q, D), points (B, N, D) -> (idx (B, Q, k) int64, sqdist
    (B, Q, k) float32).  Ties go to the lowest index: a stable sort keeps
    equal distances in index order (``torch.topk`` leaves the order of ties
    open).
    """
    sqdist, idx = torch.sort(pairwise_sqdist(query, points), dim=-1, stable=True)
    return idx[..., :k], sqdist[..., :k]
