"""Pure-numpy label/quaternion math for the host-side data path.

The torch versions (quaternion.py / labels.py) run on a tensor's device;
the data loader and the evaluation run per sample on the host, where a
device round trip per sample would dominate.  Same conventions: [w,x,y,z]
quaternions, static-xyz Euler angles in degrees, dual quaternions.  The
float64 arithmetic is the JAX package's ``geometry/hostmath.py`` in the same
order, so both give the same bits.
"""
from __future__ import annotations

import numpy as np

from .labels import LabelType

__all__ = [
    "qmult_np",
    "qconjugate_np",
    "matrix_to_quat_np",
    "quat_to_matrix_np",
    "label_from_matrix_np",
    "label_to_matrix_np",
]


def qconjugate_np(q: np.ndarray) -> np.ndarray:
    return np.concatenate([q[..., :1], -q[..., 1:]], axis=-1)


def qmult_np(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def matrix_to_quat_np(m: np.ndarray) -> np.ndarray:
    """Batched rotation matrix -> unit quaternion [w,x,y,z], w >= 0."""
    m = np.asarray(m, float)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    qw = np.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = np.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = np.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = np.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)
    scores = np.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        axis=-1,
    )
    best = np.argmax(scores, axis=-1)
    cands = np.stack([qw, qx, qy, qz], axis=-2)
    q = np.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return q * np.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, float)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = np.where(n > 0, 2.0 / np.maximum(n, 1e-30), 0.0)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.stack([
        np.stack([1.0 - (yy + zz), xy - wz, xz + wy], axis=-1),
        np.stack([xy + wz, 1.0 - (xx + zz), yz - wx], axis=-1),
        np.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], axis=-1),
    ], axis=-2)


def _euler_sxyz_np(m: np.ndarray):
    pitch = -np.arcsin(np.clip(m[..., 2, 0], -1.0, 1.0))
    cp = np.cos(pitch)
    safe = np.abs(cp) > 1e-6
    roll = np.where(
        safe,
        np.arctan2(m[..., 2, 1], m[..., 2, 2]),
        np.arctan2(-m[..., 1, 2], m[..., 1, 1]),
    )
    yaw = np.where(safe, np.arctan2(m[..., 1, 0], m[..., 0, 0]), 0.0)
    return roll, pitch, yaw


def _euler_to_matrix_np(roll, pitch, yaw):
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    return np.stack([
        np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1),
        np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1),
        np.stack([-sp, cp * sr, cp * cr], axis=-1),
    ], axis=-2)


def label_from_matrix_np(label_type: LabelType, m: np.ndarray) -> np.ndarray:
    """(..., 4, 4) transform -> (..., dim) label, pure numpy."""
    m = np.asarray(m, float)
    t = m[..., :3, 3]
    if label_type == LabelType.POSE3D_EULER:
        roll, pitch, yaw = _euler_sxyz_np(m[..., :3, :3])
        ang = np.stack([np.rad2deg(roll), np.rad2deg(pitch), np.rad2deg(yaw)], axis=-1)
        return np.concatenate([t, ang], axis=-1)
    if label_type == LabelType.POSE3D_QUAT:
        q = matrix_to_quat_np(m[..., :3, :3])
        return np.concatenate([t, q], axis=-1)
    if label_type == LabelType.POSE3D_DUAL_QUAT:
        real = matrix_to_quat_np(m[..., :3, :3])
        tq = np.concatenate([np.zeros_like(t[..., :1]), t], axis=-1)
        dual = 0.5 * qmult_np(tq, real)
        return np.concatenate([real, dual], axis=-1)
    raise NotImplementedError(label_type)


def label_to_matrix_np(label_type: LabelType, label: np.ndarray,
                       eps: float = 1e-8) -> np.ndarray:
    """(..., dim) label -> (..., 4, 4) transform, pure numpy."""
    label = np.asarray(label, float)
    batch = label.shape[:-1]
    m = np.broadcast_to(np.eye(4), batch + (4, 4)).copy()
    if label_type == LabelType.POSE3D_EULER:
        m[..., :3, :3] = _euler_to_matrix_np(
            np.deg2rad(label[..., 3]), np.deg2rad(label[..., 4]), np.deg2rad(label[..., 5])
        )
        m[..., :3, 3] = label[..., :3]
        return m
    if label_type == LabelType.POSE3D_QUAT:
        q = label[..., 3:]
        q = q / (np.linalg.norm(q, axis=-1, keepdims=True) + eps)
        m[..., :3, :3] = quat_to_matrix_np(q)
        m[..., :3, 3] = label[..., :3]
        return m
    if label_type == LabelType.POSE3D_DUAL_QUAT:
        norm = np.linalg.norm(label[..., :4], axis=-1, keepdims=True) + eps
        dq = label / norm
        m[..., :3, :3] = quat_to_matrix_np(dq[..., :4])
        tq = 2.0 * qmult_np(dq[..., 4:], qconjugate_np(dq[..., :4]))
        m[..., :3, 3] = tq[..., 1:]
        return m
    raise NotImplementedError(label_type)
