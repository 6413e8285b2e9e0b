"""PointNet++ feature propagation (FP): upsample features from a sparse
point set to a dense one by inverse-distance-weighted 3-NN interpolation,
then a unit MLP.  DeepCLR does not use it; it completes the PointNet++
toolbox of the JAX package (``deepclr_tpu/models/feature_propagation.py``)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .. import ops
from .layers import MLP

__all__ = ["FeaturePropagation"]


class FeaturePropagation(nn.Module):
    """``in_dim`` is the known features' width plus the skip features'
    (Flax infers it at init; a torch module needs it up front); ``mlp`` the
    widths of the MLP after the interpolation."""

    def __init__(self, in_dim: int, mlp: Sequence[int], batch_norm: bool = False,
                 compute_dtype=torch.float32):
        super().__init__()
        self.mlp = MLP(in_dim, mlp, compute_dtype, batch_norm=batch_norm)

    def forward(self, unknown_xyz: torch.Tensor, known_xyz: torch.Tensor,
                unknown_feats: Optional[torch.Tensor] = None, known_feats: Optional[torch.Tensor] = None,
                known_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """unknown_xyz (B, N, 3), known_xyz (B, M, 3), optional skip features
        unknown_feats (B, N, C1), known_feats (B, M, C2), optional known_mask
        (B, M) -> (B, N, mlp[-1]) float32."""
        dist, idx = ops.three_nn(unknown_xyz, known_xyz, known_mask)
        h = ops.three_interpolate(known_feats, idx, ops.three_interpolate_weights(dist))
        if unknown_feats is not None:
            h = torch.cat([h, unknown_feats], dim=-1)
        return self.mlp(h).float()
