"""Pose label parameterizations: three interchangeable encodings of a rigid
transform, with the identity-bias values that initialize the regression
head.  ``to_matrix`` is batched over leading axes."""
from __future__ import annotations

import enum
import math
from typing import List, Optional

import torch

from . import quaternion as quat
from . import se3

__all__ = ["LabelType"]


class LabelType(enum.Enum):
    """Available label types and their transform parameterizations."""

    POSE3D_EULER = "pose3d_euler"
    POSE3D_QUAT = "pose3d_quat"
    POSE3D_DUAL_QUAT = "pose3d_dual_quat"

    @classmethod
    def create(cls, value) -> "LabelType":
        if isinstance(value, cls):
            return value
        return cls(str(value).lower())

    @property
    def dim(self) -> int:
        return {
            LabelType.POSE3D_EULER: 6,
            LabelType.POSE3D_QUAT: 7,
            LabelType.POSE3D_DUAL_QUAT: 8,
        }[self]

    @property
    def bias(self) -> Optional[List[float]]:
        """Head-bias values so an untrained model predicts identity."""
        if self == LabelType.POSE3D_EULER:
            return None
        if self == LabelType.POSE3D_QUAT:
            return [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]
        return [1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]

    def to_matrix(self, label: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
        """(..., dim) label -> (..., 4, 4) transform."""
        if scale is not None:
            label = label / scale
        if self == LabelType.POSE3D_EULER:
            rad = label[..., 3:6] * (math.pi / 180.0)
            r = se3.euler_to_matrix(rad[..., 0], rad[..., 1], rad[..., 2])
            return se3.make_transform(r, label[..., :3])
        if self == LabelType.POSE3D_QUAT:
            r = quat.quat_to_matrix(quat.qnormalize(label[..., 3:]))
            return se3.make_transform(r, label[..., :3])
        return se3.dualquat_to_matrix(label)
