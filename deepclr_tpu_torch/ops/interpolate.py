"""three_nn / three_interpolate: inverse-distance-weighted interpolation
from the 3 nearest known points (PointNet++ feature propagation)."""
from __future__ import annotations

from typing import Optional

import torch

from .grouping import group_points
from .knn import knn

__all__ = ["three_interpolate", "three_interpolate_weights", "three_nn"]


def three_nn(unknown: torch.Tensor, known: torch.Tensor, known_mask: Optional[torch.Tensor] = None):
    """unknown (B, N, 3), known (B, M, 3), optional known_mask (B, M) ->
    (dist (B, N, 3) euclidean distances, idx (B, N, 3) int64), nearest first."""
    idx, d2 = knn(unknown, known, 3, points_mask=known_mask)
    return torch.sqrt(d2), idx


def three_interpolate(features: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """features (B, M, C), idx (B, N, 3), weight (B, N, 3) -> (B, N, C), the
    weighted sum of the 3 neighbours' features."""
    return torch.sum(group_points(features, idx) * weight[..., None], dim=-2)


def three_interpolate_weights(dist: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights, normalised over the 3 neighbours."""
    recip = 1.0 / (dist + eps)
    return recip / torch.sum(recip, dim=-1, keepdim=True)
