"""The geometric rules the reference shares with the program, in plain
float32 PyTorch, so that both pick the same centres, balls and neighbours.

Frozen copies: ``sq_dist`` of ``_sq_dist`` in
``deepclr_tpu_torch/ops/fused_sa.py`` (each product rounded, summed x, y,
z), ``morton_code`` / ``morton_sort`` of ``ops/morton.py``
(``morton_code``, ``spatial_sort``), ``fps`` of ``ops/fps.py``
(``_fps_plain``), ``pairwise_sqdist`` of ``ops/pairwise.py`` and
``SORT_MIN_POINTS`` of ``models/pointnet2.py``.
"""
from __future__ import annotations

import torch

SORT_MIN_POINTS = 4096  # clouds this large are Morton-sorted before sampling
_BITS = 10
INVALID_CODE = 0xFFFFFFFF


def sq_dist(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(x - c)^2 summed x, y, z, each product rounded, broadcast over the
    leading axes of p (..., 3) and c (..., 3)."""
    dx = p[..., 0] - c[..., 0]
    d2 = dx * dx
    dy = p[..., 1] - c[..., 1]
    d2 = d2 + dy * dy
    dz = p[..., 2] - c[..., 2]
    return d2 + dz * dz


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_code(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, N) int64 Z-order codes on cubic cells;
    invalid points get ``INVALID_CODE``."""
    lo = torch.amin(xyz, dim=1, keepdim=True)
    hi = torch.amax(xyz, dim=1, keepdim=True)
    extent = torch.clamp_min(torch.amax(hi - lo, dim=-1, keepdim=True), 1e-6)
    scale = (2 ** _BITS - 1) / extent
    q = torch.clamp((xyz - lo) * scale, 0, 2 ** _BITS - 1).to(torch.int64)
    code = (_expand_bits(q[..., 0]) << 2) | (_expand_bits(q[..., 1]) << 1) | _expand_bits(q[..., 2])
    return torch.where(mask, code, torch.full_like(code, INVALID_CODE))


def morton_sort(xyz, feats, mask):
    """Stable sort of a padded cloud by Morton code, invalid points last."""
    code = morton_code(xyz, mask)
    sorted_code, order = torch.sort(code, dim=1, stable=True)
    xyz = torch.gather(xyz, 1, order[..., None].expand(-1, -1, xyz.shape[-1]))
    if feats is not None:
        feats = torch.gather(feats, 1, order[..., None].expand(-1, -1, feats.shape[-1]))
    return xyz, feats, sorted_code != INVALID_CODE


def fps(xyz: torch.Tensor, npoint: int, mask: torch.Tensor) -> torch.Tensor:
    """Furthest point sampling: start at the lowest valid index, then the
    point with the largest running min squared distance, ties to the lowest
    index -> (B, npoint) int64."""
    b = xyz.shape[0]
    rows = torch.arange(b, device=xyz.device)
    dists = torch.where(mask, 1e10, -1.0).to(torch.float32)
    idx = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    idx[:, 0] = torch.argmax(mask.to(torch.int8), dim=1)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    for i in range(1, npoint):
        c = xyz[rows, idx[:, i - 1]]
        dx = x - c[:, 0:1]
        dy = y - c[:, 1:2]
        dz = z - c[:, 2:3]
        d = dx * dx + dy * dy + dz * dz
        dists = torch.minimum(dists, torch.where(mask, d, -1.0))
        idx[:, i] = torch.argmax(dists, dim=1)
    return idx


def _sqnorm(x: torch.Tensor) -> torch.Tensor:
    out = x[..., 0] * x[..., 0]
    for k in range(1, x.shape[-1]):
        out = out + x[..., k] * x[..., k]
    return out


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a||^2 + ||b||^2 - 2 a.b^T in float32, clamped at 0."""
    a = a.float()
    b = b.float()
    cross = torch.matmul(a, b.transpose(-1, -2))
    d2 = _sqnorm(a)[..., :, None] + _sqnorm(b)[..., None, :] - 2.0 * cross
    return torch.clamp_min(d2, 0.0)
