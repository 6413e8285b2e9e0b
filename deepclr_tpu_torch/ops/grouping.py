"""Gather / group: index-select points or neighbourhoods (channel-last)."""
from __future__ import annotations

import torch

__all__ = ["gather_points", "group_points"]


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) points, (B, P) indices -> (B, P, C)."""
    idx = idx.long()[..., None].expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, idx)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) points, (B, P, S) indices -> (B, P, S, C)."""
    b, p, s = idx.shape
    return gather_points(points, idx.reshape(b, p * s)).reshape(b, p, s, -1)
