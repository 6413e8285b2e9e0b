"""SE(3) helpers on torch tensors: 4x4 transforms, Euler angles, dual
quaternions.  Euler convention is static XYZ: R = Rz(yaw) @ Ry(pitch) @
Rx(roll).  Products are meant as float32 with TF32 off
(``deepclr_tpu_torch.device.strict_float32``)."""
from __future__ import annotations

import torch

from . import quaternion as quat

__all__ = [
    "make_transform",
    "transform_points",
    "euler_to_matrix",
    "dualquat_from_matrix",
    "dualquat_to_matrix",
    "dualquat_normalize",
    "dualquat_translation",
]


def make_transform(rotation: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) transforms from R (..., 3, 3) and t (..., 3)."""
    batch = torch.broadcast_shapes(rotation.shape[:-2], translation.shape[:-1])
    rotation = rotation.expand(*batch, 3, 3)
    translation = translation.expand(*batch, 3)
    top = torch.cat([rotation, translation[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)
    return torch.cat([top, bottom.expand(*batch, 1, 4)], dim=-2)


def transform_points(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) transforms to (..., N, 3) points."""
    r = m[..., :3, :3]
    t = m[..., :3, 3]
    return torch.matmul(pts, r.transpose(-1, -2)) + t[..., None, :]


def euler_to_matrix(roll, pitch, yaw) -> torch.Tensor:
    """Static-XYZ Euler angles [rad] -> rotation matrix."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1),
            torch.stack([-sp, cp * sr, cp * cr], dim=-1),
        ],
        dim=-2,
    )


# A rigid transform (R, t) maps to (q_r, q_d) with q_r = quat(R) and
# q_d = 0.5 * (0, t) ⊗ q_r; recovery: t = 2 * q_d ⊗ q_r*.


def dualquat_from_matrix(m: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 8) dual quaternion [real(4), dual(4)]."""
    real = quat.matrix_to_quat(m[..., :3, :3])
    t = m[..., :3, 3]
    tq = torch.cat([torch.zeros_like(t[..., :1]), t], dim=-1)
    return torch.cat([real, 0.5 * quat.qmult(tq, real)], dim=-1)


def dualquat_normalize(dq: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Divide both parts by the norm of the real part."""
    return dq / (torch.linalg.vector_norm(dq[..., :4], dim=-1, keepdim=True) + eps)


def dualquat_translation(dq: torch.Tensor) -> torch.Tensor:
    """Translation vector encoded by a (normalized) dual quaternion."""
    return (2.0 * quat.qmult(dq[..., 4:], quat.qconjugate(dq[..., :4])))[..., 1:]


def dualquat_to_matrix(dq: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 8) dual quaternion -> (..., 4, 4), normalizing the real part."""
    dq = dualquat_normalize(dq, eps)
    return make_transform(quat.quat_to_matrix(dq[..., :4]), dualquat_translation(dq))
