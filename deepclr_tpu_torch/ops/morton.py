"""Morton (Z-order) spatial sorting for point clouds.

Sorting points by Morton code makes consecutive points spatially adjacent,
so the fused set-abstraction kernel can skip (point chunk x centre tile)
blocks that hold no in-radius pair.  Radius membership and max-pooling are
order-invariant, so the sort changes no result; FPS, however, starts at the
first sorted point, so the order itself must match the reference exactly:
the codes, their float32 quantisation and a stable sort.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["morton_code", "morton_argsort_np", "spatial_sort", "INVALID_CODE"]

_BITS = 10  # 10 bits per axis -> 30-bit codes
INVALID_CODE = 0xFFFFFFFF  # sorts after every 30-bit code


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so there are 2 zero bits between each
    (int64: torch's uint32 shifts are limited; no value here exceeds 2^30)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_code(xyz: torch.Tensor, mask=None) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, N) int64 codes; invalid points get
    ``INVALID_CODE``.  All axes share one metric scale (cubic cells)."""
    lo = torch.amin(xyz, dim=1, keepdim=True)
    hi = torch.amax(xyz, dim=1, keepdim=True)
    extent = torch.clamp_min(torch.amax(hi - lo, dim=-1, keepdim=True), 1e-6)
    scale = (2 ** _BITS - 1) / extent
    q = torch.clamp((xyz - lo) * scale, 0, 2 ** _BITS - 1).to(torch.int64)
    code = (_expand_bits(q[..., 0]) << 2) | (_expand_bits(q[..., 1]) << 1) | _expand_bits(q[..., 2])
    if mask is not None:
        code = torch.where(mask, code, torch.full_like(code, INVALID_CODE))
    return code


def morton_argsort_np(xyz: np.ndarray) -> np.ndarray:
    """Host (numpy) Morton argsort of one un-padded cloud: (N, >=3) -> (N,).

    The host sorts a cloud once when it pads it, so a model built with
    ``presorted`` skips the first stage's device point sort.  The cells are
    ``morton_code``'s, but quantised in float64: the order can differ from
    the device sort's (float32) at cell boundaries, and FPS starts at the
    first point, so a presorted model is compared with a presorted model.
    numpy's uint32 shifts wrap like the JAX package's.
    """
    q = xyz[:, :3].astype(np.float64)
    lo = q.min(axis=0)
    scale = (2 ** _BITS - 1) / max(float((q.max(axis=0) - lo).max()), 1e-6)
    v = np.clip((q - lo) * scale, 0, 2 ** _BITS - 1).astype(np.uint32)
    v = (v | (v << np.uint32(16))) & np.uint32(0x030000FF)
    v = (v | (v << np.uint32(8))) & np.uint32(0x0300F00F)
    v = (v | (v << np.uint32(4))) & np.uint32(0x030C30C3)
    v = (v | (v << np.uint32(2))) & np.uint32(0x09249249)
    code = (v[:, 0] << np.uint32(2)) | (v[:, 1] << np.uint32(1)) | v[:, 2]
    return np.argsort(code, kind="stable")


def spatial_sort(xyz: torch.Tensor, features=None, mask=None):
    """Stable sort of a padded cloud by Morton code (invalid points last).

    Returns (xyz, features, mask) with the input shapes; the sorted mask is
    read back from the sentinel code.
    """
    code = morton_code(xyz, mask)
    sorted_code, order = torch.sort(code, dim=1, stable=True)
    xyz = torch.gather(xyz, 1, order[..., None].expand(-1, -1, xyz.shape[-1]))
    if features is not None:
        features = torch.gather(features, 1, order[..., None].expand(-1, -1, features.shape[-1]))
    if mask is not None:
        mask = sorted_code != INVALID_CODE
    return xyz, features, mask
