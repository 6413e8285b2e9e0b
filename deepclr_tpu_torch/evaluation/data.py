"""Motion / Sequence containers and their text files.

A sequence file has one row per frame pair, 26 columns: [stamp, 12 predicted
transform values, 12 ground-truth transform values, time in ms], written by
``np.savetxt`` from float64, so the same rows give the same bytes as the JAX
package's ``evaluation/data.py``.  Motion files are KITTI-style 12-column
pose/transform rows.
"""
from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["Motion", "Sequence"]


def _vec_to_mat(v: np.ndarray) -> np.ndarray:
    m = np.eye(4)
    m[:3, :] = np.asarray(v).reshape(3, 4)
    return m


def _mat_to_vec(m: np.ndarray) -> np.ndarray:
    return np.asarray(m)[:3, :].reshape(12)


def rigid_inverse(m: np.ndarray) -> np.ndarray:
    """Inverse of a rigid (4, 4) transform, float64."""
    out = np.eye(4)
    r = m[:3, :3].T
    out[:3, :3] = r
    out[:3, 3] = -r @ m[:3, 3]
    return out


class Motion:
    """Relative transforms, cumulative poses and traveled distances."""

    def __init__(self):
        self.transforms: List[np.ndarray] = []
        self.poses: List[np.ndarray] = []
        self.distances: List[float] = []

    def add_transform(self, m: np.ndarray) -> None:
        m = np.asarray(m, float)
        self.transforms.append(m)
        if not self.poses:
            self.poses.append(np.eye(4))
            self.distances.append(0.0)
        self.poses.append(self.poses[-1] @ m)
        self.distances.append(
            self.distances[-1] + float(np.linalg.norm(m[:3, 3]))
        )

    def add_pose(self, m: np.ndarray) -> None:
        m = np.asarray(m, float)
        self.poses.append(m)
        if len(self.poses) > 1:
            transform = rigid_inverse(self.poses[-2]) @ self.poses[-1]
            self.transforms.append(transform)
            self.distances.append(
                self.distances[-1] + float(np.linalg.norm(transform[:3, 3]))
            )
        else:
            self.distances.append(0.0)

    def get_path(self) -> np.ndarray:
        return np.array([p[:3, 3] for p in self.poses])

    def get_frame_by_distance(self, first_frame: int, distance: float) -> int:
        """First frame whose cumulative distance exceeds start+distance."""
        target = self.distances[first_frame] + distance
        for i in range(first_frame, len(self.distances)):
            if self.distances[i] > target:
                return i
        return -1

    @classmethod
    def read(cls, filename: str, has_poses: bool) -> "Motion":
        motion = cls()
        data = np.atleast_2d(np.loadtxt(filename))
        for row in data:
            m = _vec_to_mat(row[:12])
            if has_poses:
                motion.add_transform(m)
            else:
                motion.add_pose(m)
        return motion

    def write(self, filename: str, use_poses: bool) -> None:
        export = self.poses if use_poses else self.transforms
        np.savetxt(filename, np.array([_mat_to_vec(m) for m in export]))


class Sequence:
    """Predicted + ground-truth motion with timestamps and inference times."""

    def __init__(self):
        self.prediction = Motion()
        self.ground_truth = Motion()
        self.stamps: List[float] = []
        self.times: List[float] = []

    def add_transforms(self, stamp: float, pred: np.ndarray, gt: np.ndarray,
                       time: float = 0.0) -> None:
        self.stamps.append(float(stamp))
        self.prediction.add_transform(pred)
        self.ground_truth.add_transform(gt)
        self.times.append(float(time))

    def add_poses(self, stamp: float, pred: np.ndarray, gt: np.ndarray,
                  time: float = 0.0) -> None:
        self.stamps.append(float(stamp))
        self.prediction.add_pose(pred)
        self.ground_truth.add_pose(gt)
        self.times.append(float(time))

    def __len__(self) -> int:
        return len(self.stamps)

    @classmethod
    def read(cls, filename: str) -> "Sequence":
        seq = cls()
        data = np.atleast_2d(np.loadtxt(filename))
        for row in data:
            seq.add_transforms(
                row[0], _vec_to_mat(row[1:13]), _vec_to_mat(row[13:25]), row[25]
            )
        return seq

    @classmethod
    def read_separate(cls, filename_pred: str, filename_gt: str,
                      has_poses: bool) -> "Sequence":
        seq = cls()
        seq.prediction = Motion.read(filename_pred, has_poses)
        seq.ground_truth = Motion.read(filename_gt, has_poses)
        size = len(seq.prediction.transforms)
        if len(seq.ground_truth.transforms) != size:
            raise RuntimeError(
                "Sizes of prediction and ground truth files do not match."
            )
        seq.stamps = np.arange(size, dtype=float).tolist()
        seq.times = np.zeros(size).tolist()
        return seq

    def write(self, filename: str) -> None:
        rows = [
            np.concatenate(([stamp], _mat_to_vec(pred), _mat_to_vec(gt), [time]))
            for stamp, pred, gt, time in zip(
                self.stamps, self.prediction.transforms,
                self.ground_truth.transforms, self.times,
            )
        ]
        np.savetxt(filename, np.array(rows))
