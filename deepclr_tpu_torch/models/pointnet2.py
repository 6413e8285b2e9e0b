"""PointNet++ multi-scale set abstraction.  Two paths share one parameter
layout, so one state dict serves both:

* fused (default): FPS picks the centres, then one fused ball-MLP-max pass
  computes every MSG scale at once (``ops.ball_mlp_max``).  Neighbourhoods
  are the full radius ball.
* exact: FPS, then per scale ``ops.ball_query`` (the first ``nsample`` hits
  in index order, the rest filled with the first), the grouped offsets and
  features through the scale's MLP, and the max over the samples: the
  reference's semantics, in plain PyTorch.  The points are never reordered,
  since which points a full ball keeps depends on their order.

Layout is channel-last: a cloud is (B, N, 3) xyz, optional (B, N, C)
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
    """Multi-scale-grouping set abstraction: npoint centres, one radius,
    one ``nsample`` (the exact path's ball size) and one MLP per scale; xyz
    offsets are always prepended to the features."""

    def __init__(self, in_dim: int, npoint: int, radii: Sequence[float],
                 mlps: Sequence[Sequence[int]], compute_dtype=torch.float32, presorted: bool = False,
                 nsamples: Optional[Sequence[int]] = None, fused: bool = True):
        super().__init__()
        nsamples = tuple(int(n) for n in nsamples) if nsamples is not None else None
        if len(radii) != len(mlps) or (nsamples is not None and len(nsamples) != len(mlps)):
            raise ValueError("one radius (and one nsample) per MLP scale")
        if not fused and nsamples is None:
            raise ValueError("the exact path needs nsamples")
        self.npoint = int(npoint)
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = nsamples
        self.fused = bool(fused)
        self.mlps = nn.ModuleList([_ScaleMLP(in_dim, m) for m in mlps])
        self.compute_dtype = compute_dtype
        # the input cloud is Morton-ordered by the host (ModelInferenceHelper
        # pads it so): the point sort is skipped, the centre sort kept.  An
        # unordered input only weakens the culling, never the result.
        self.presorted = bool(presorted)

    @property
    def out_dim(self) -> int:
        return sum(m.dense(m.depth - 1).weight.shape[0] for m in self.mlps)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (new_xyz (B, npoint, 3), new_features (B, npoint, F) float32)."""
        if not self.fused:
            return self._exact(xyz, features, mask)
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
            compute_dtype=self.compute_dtype)
        return new_xyz, new_features

    def _exact(self, xyz, features, mask):
        fps_idx = ops.furthest_point_sample(xyz, self.npoint, mask=mask)
        new_xyz = ops.gather_points(xyz, fps_idx)
        # one distance pass serves every scale
        indices = ops.ball_query_scales(xyz, new_xyz, self.radii, self.nsamples, mask)
        return new_xyz, self.grouped_mlp(xyz, features, new_xyz, indices)

    def grouped_mlp(self, xyz: torch.Tensor, features: Optional[torch.Tensor], new_xyz: torch.Tensor,
                    indices: Sequence[torch.Tensor]) -> torch.Tensor:
        """The exact path after its ball query: per scale, the grouped
        offsets and features (cast to the compute dtype before layer 1),
        the scale's MLP, and the max over the samples -> (B, P, F) float32."""
        cd = self.compute_dtype
        scale_feats = []
        for m, idx in zip(self.mlps, indices):
            grouped = ops.group_points(xyz, idx) - new_xyz[:, :, None, :]
            if features is not None:
                grouped = torch.cat([grouped, ops.group_points(features, idx)], dim=-1)
            h = grouped.to(cd)
            for i in range(m.depth):
                h = torch.relu(m.dense(i)(h, cd))
            # amax splits the gradient evenly between equal maxima, as JAX's
            # max does; the duplicate fill makes ties the rule
            scale_feats.append(torch.amax(h, dim=-2).float())
        return torch.cat(scale_feats, dim=-1)
