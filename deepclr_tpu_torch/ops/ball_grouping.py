"""Ball query: fixed-size radius neighbourhoods around sampled centres.

The reference's contract (the exact set-abstraction path): for each
centre, the first ``nsample`` points in index order whose squared distance
is below radius²; unfilled slots repeat the first hit; a centre with no
point in its ball gets zeros.  Distances are the expanded form of
``pairwise_sqdist``, as in the JAX package, so a point within its rounding
(~5e-4 m² at 80 m) of the sphere may fall on either side on another device.

The (centre, point) distances are built one block of centres at a time
(``block_centres``), so the scratch stays within ``SCRATCH_BYTES`` whatever
the cloud count and size, and serve every scale of a multi-scale grouping
(``ball_query_scales``).  A point's rank is the int32 running count of
its centre's hits up to it; slot s takes the first point of rank s + 1, a
binary search in that non-decreasing row (no host sync, no list of hits).
A radius of 0 finds nothing: the JAX package clamps distances at 0 and
tests d² < r².
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .pairwise import _sqnorm

__all__ = ["SCRATCH_BYTES", "ball_query", "ball_query_scales", "block_centres"]

SCRATCH_BYTES = 2 << 30
# the float32 distances and the matmul's product, then the distances, the
# hit flags and their int32 ranks: at most 9, with room to spare
_BYTES_PER_ENTRY = 13


def block_centres(b: int, p: int, n: int) -> int:
    """Centres a block: the most whose (B, block, N) scratch fits SCRATCH_BYTES."""
    return max(1, min(p, SCRATCH_BYTES // (_BYTES_PER_ENTRY * b * max(1, n))))


def ball_query(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float, nsample: int,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xyz (B, N, 3) points (padded), new_xyz (B, P, 3) centres, optional
    mask (B, N) bool -> (B, P, nsample) int64 indices into N."""
    return ball_query_scales(xyz, new_xyz, [radius], [nsample], mask)[0]


def ball_query_scales(xyz: torch.Tensor, new_xyz: torch.Tensor, radii: Sequence[float],
                      nsamples: Sequence[int], mask: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """``ball_query`` at several (radius, nsample) scales around the same
    centres, the distances computed once: a list of (B, P, nsample) int64."""
    xyz, new_xyz = xyz.float(), new_xyz.float()
    b, n, _ = xyz.shape
    p = new_xyz.shape[1]
    outs = [torch.zeros(b, p, ns, dtype=torch.int64, device=xyz.device) for ns in nsamples]
    sq_pts = _sqnorm(xyz)[:, None, :]
    step = block_centres(b, p, n)
    for lo in range(0, p, step):
        c = new_xyz[:, lo:lo + step]
        # pairwise_sqdist's rounding, in place: (|c|² + |x|²) − 2 c·x; its
        # clamp at 0 changes no comparison with a positive r²
        cross = torch.matmul(c, xyz.transpose(1, 2))
        d2 = (_sqnorm(c)[:, :, None] + sq_pts).sub_(cross, alpha=2.0)
        del cross
        for out, radius, nsample in zip(outs, radii, nsamples):
            if radius > 0.0:  # r² rounded to float32, as JAX compares
                r2 = float(torch.tensor(radius * radius, dtype=torch.float32))
                out[:, lo:lo + step] = _slots(d2 < r2, mask, nsample)
    return outs


def _slots(hit: torch.Tensor, mask: Optional[torch.Tensor], nsample: int) -> torch.Tensor:
    """(B, P, N) hits -> (B, P, nsample): the first nsample in index order,
    the rest the first hit (0 in an empty ball)."""
    b, p, n = hit.shape
    if mask is not None:
        hit &= mask[:, None, :]
    rank = torch.cumsum(hit.view(-1, n), -1, dtype=torch.int32)
    counts = rank[:, -1:]
    wanted = torch.arange(1, nsample + 1, dtype=torch.int32, device=hit.device).expand(rank.shape[0], nsample)
    # slot s: the first point whose rank reaches s + 1 (n where none does)
    out = torch.searchsorted(rank, wanted.contiguous())
    filled = torch.arange(nsample, device=hit.device) < counts
    out = torch.where(filled, out, torch.where(counts > 0, out[:, :1], 0))
    return out.view(b, p, nsample)
