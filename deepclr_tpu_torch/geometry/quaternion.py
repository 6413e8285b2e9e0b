"""Batched quaternion algebra on torch tensors.

Convention: quaternions are stored ``[w, x, y, z]`` (scalar first).  Every
function works on the last axis and broadcasts over the leading ones.
"""
from __future__ import annotations

import torch

__all__ = [
    "qconjugate",
    "qmult",
    "qnormalize",
    "quat_to_matrix",
    "matrix_to_quat",
]


def qconjugate(q: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate: negate the vector part."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qmult(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2 on the last axis."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def qnormalize(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Normalize to unit norm (the eps guards a zero quaternion)."""
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + eps)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) -> rotation matrix(es) ``(..., 3, 3)``."""
    w, x, y, z = q.unbind(-1)
    n = w * w + x * x + y * y + z * z
    s = torch.where(n > 0, 2.0 / n, torch.zeros_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack(
        [
            torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
            torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
            torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix(es) -> unit quaternion ``[w, x, y, z]`` with w >= 0.

    Branch-free Shepperd's method: the candidate with the largest
    denominator is selected per matrix.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    scores = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(scores, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)
