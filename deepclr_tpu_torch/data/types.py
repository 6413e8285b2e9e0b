"""Dataset types: how a pack file's records become pair samples."""
from __future__ import annotations

import enum

__all__ = ["DatasetType"]


class DatasetType(enum.Enum):
    GENERIC = "generic"
    KITTI_ODOMETRY_VELODYNE = "kitti_odometry_velodyne"
    MODELNET40 = "modelnet40"

    @classmethod
    def create(cls, value) -> "DatasetType":
        if isinstance(value, cls):
            return value
        return cls(str(value).lower())
