"""PointNet++ multi-scale set abstraction, fused path.

FPS picks the centres, then one fused ball-MLP-max pass computes every MSG
scale at once (``ops.ball_mlp_max``).  Neighbourhoods are the full radius
ball.  Layout is channel-last: a cloud is (B, N, 3) xyz, optional (B, N, C)
features and an optional (B, N) bool validity mask.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .. import ops
from .layers import Dense

__all__ = ["SetAbstractionMSG", "SORT_MIN_POINTS"]

# below this cloud size, Morton sorting costs more than culling saves
SORT_MIN_POINTS = 4096


class _ScaleLayer(nn.Module):
    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.conv = Dense(in_features, out_features, init="kaiming_normal")


class _ScaleMLP(nn.Module):
    """One MSG scale's MLP; layer i is ``layer{i}.conv``."""

    def __init__(self, in_dim: int, widths: Sequence[int]):
        super().__init__()
        dims = [in_dim, *widths]
        self.depth = len(widths)
        for i in range(self.depth):
            self.add_module(f"layer{i}", _ScaleLayer(dims[i], dims[i + 1]))

    def dense(self, i: int) -> Dense:
        return getattr(self, f"layer{i}").conv


class SetAbstractionMSG(nn.Module):
    """Multi-scale-grouping set abstraction: npoint centres, one radius and
    one MLP per scale; xyz offsets are always prepended to the features."""

    def __init__(self, in_dim: int, npoint: int, radii: Sequence[float],
                 mlps: Sequence[Sequence[int]], compute_dtype=torch.float32, presorted: bool = False):
        super().__init__()
        if len(radii) != len(mlps):
            raise ValueError("one radius per MLP scale")
        self.npoint = int(npoint)
        self.radii = tuple(float(r) for r in radii)
        self.mlps = nn.ModuleList([_ScaleMLP(in_dim, m) for m in mlps])
        self.compute_dtype = compute_dtype
        # the input cloud is Morton-ordered by the host (ModelInferenceHelper
        # pads it so): the point sort is skipped, the centre sort kept.  An
        # unordered input only weakens the culling, never the result.
        self.presorted = bool(presorted)
        # the fused op's backward: "kernel" (equality-select) or "argmax"
        self.backward = "kernel"

    @property
    def out_dim(self) -> int:
        return sum(m.dense(m.depth - 1).weight.shape[0] for m in self.mlps)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (new_xyz (B, npoint, 3), new_features (B, npoint, F))."""
        want_sorted = xyz.shape[1] >= SORT_MIN_POINTS
        if want_sorted and not self.presorted:
            # Morton order makes point chunks compact, so the culling bites;
            # radius membership and max-pool are order-invariant
            xyz, features, mask = ops.spatial_sort(xyz, features, mask)

        fps_idx = ops.furthest_point_sample(xyz, self.npoint, mask=mask)
        new_xyz = ops.gather_points(xyz, fps_idx)
        if want_sorted:
            # spatially tight centre tiles cull better
            new_xyz = ops.spatial_sort(new_xyz)[0]

        weights, biases, radius_cols = ops.multi_scale_bundle(
            [[m.dense(i).weight.t() for i in range(m.depth)] for m in self.mlps],
            [[m.dense(i).bias for i in range(m.depth)] for m in self.mlps],
            self.radii,
        )
        new_features = ops.ball_mlp_max(
            xyz, new_xyz, weights, biases, radius_cols, features=features, mask=mask,
            compute_dtype=self.compute_dtype, backward=self.backward)
        return new_xyz, new_features
