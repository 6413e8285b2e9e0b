"""KITTI-style pose error metrics (host-side numpy, float64).

KITTI translation / rotation errors (min over both difference directions),
RMSE variants, the chordal rotation error, and min/max/mean/median/std
accumulation; the same arithmetic as the JAX package's
``evaluation/metrics.py``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence as Seq, Tuple, Union

import numpy as np

from .data import rigid_inverse as _rigid_inverse

__all__ = [
    "translation_error_kitti",
    "translation_error_rmse",
    "rotation_error_kitti",
    "rotation_error_rmse",
    "rotation_error_chordal",
    "TranslationError",
    "RotationError",
    "TransformationMetrics",
    "SegmentMetrics",
    "MetricsContainer",
]


def _euler_sxyz(r: np.ndarray) -> np.ndarray:
    """Static-XYZ Euler angles from a rotation matrix (numpy)."""
    pitch = -np.arcsin(np.clip(r[2, 0], -1.0, 1.0))
    if abs(np.cos(pitch)) > 1e-6:
        roll = np.arctan2(r[2, 1], r[2, 2])
        yaw = np.arctan2(r[1, 0], r[0, 0])
    else:
        roll = np.arctan2(-r[1, 2], r[1, 1])
        yaw = 0.0
    return np.array([roll, pitch, yaw])


def _translation_error(diff: np.ndarray) -> Tuple[float, np.ndarray]:
    return float(np.linalg.norm(diff[:3, 3])), diff[:3, 3]


def translation_error_kitti(m1: np.ndarray, m2: np.ndarray) -> Tuple[float, np.ndarray]:
    """KITTI translation error: min over both difference directions."""
    e1, v1 = _translation_error(m1 @ _rigid_inverse(m2))
    e2, v2 = _translation_error(m2 @ _rigid_inverse(m1))
    return (e1, v1) if e1 < e2 else (e2, v2)


def translation_error_rmse(m1: np.ndarray, m2: np.ndarray) -> float:
    diff = m1[:3, 3] - m2[:3, 3]
    return float(np.sqrt(np.sum(diff ** 2) / 3.0))


def _rotation_error(diff: np.ndarray) -> Tuple[float, np.ndarray]:
    d = 0.5 * (np.trace(diff[:3, :3]) - 1.0)
    err = float(np.arccos(np.clip(d, -1.0, 1.0)))
    return err, _euler_sxyz(diff[:3, :3])


def rotation_error_kitti(m1: np.ndarray, m2: np.ndarray) -> Tuple[float, np.ndarray]:
    """KITTI rotation error: min over both difference directions."""
    e1, v1 = _rotation_error(m1 @ _rigid_inverse(m2))
    e2, v2 = _rotation_error(m2 @ _rigid_inverse(m1))
    return (e1, v1) if e1 < e2 else (e2, v2)


def rotation_error_rmse(m1: np.ndarray, m2: np.ndarray) -> float:
    e1 = _euler_sxyz(m1[:3, :3])
    e2 = _euler_sxyz(m2[:3, :3])
    return float(np.sqrt(np.sum((e1 - e2) ** 2) / 3.0))


def rotation_error_chordal(m1: np.ndarray, m2: np.ndarray) -> float:
    """Chordal rotation error (geodesic angle from the chordal distance).

    ||R1-R2||_F = 2*sqrt(2)*sin(theta/2), hence theta = 2*asin(fro/sqrt(8)).
    """
    fro = np.linalg.norm(m1[:3, :3] - m2[:3, :3], ord="fro")
    return float(2.0 * np.arcsin(np.clip(fro / np.sqrt(8.0), -1.0, 1.0)))


class TranslationError:
    """Multiple translation error metrics for one transform pair."""

    def __init__(self, kitti: float, rmse: float, vec: np.ndarray):
        self.kitti = kitti
        self.rmse = rmse
        self.vec = vec

    @classmethod
    def calc(cls, m1: np.ndarray, m2: np.ndarray) -> "TranslationError":
        kitti, vec = translation_error_kitti(m1, m2)
        return cls(kitti, translation_error_rmse(m1, m2), vec)

    def divide(self, x: float) -> None:
        self.kitti /= x
        self.rmse /= x
        self.vec = self.vec / x

    @staticmethod
    def metrics() -> List[str]:
        return ["kitti", "rmse", "vec"]


class RotationError:
    """Multiple rotation error metrics for one transform pair."""

    def __init__(self, kitti: float, rmse: float, chordal: float, vec: np.ndarray):
        self.kitti = kitti
        self.rmse = rmse
        self.chordal = chordal
        self.vec = vec

    @classmethod
    def calc(cls, m1: np.ndarray, m2: np.ndarray) -> "RotationError":
        kitti, vec = rotation_error_kitti(m1, m2)
        return cls(kitti, rotation_error_rmse(m1, m2),
                   rotation_error_chordal(m1, m2), vec)

    def divide(self, x: float) -> None:
        self.kitti /= x
        self.rmse /= x
        self.chordal /= x
        self.vec = self.vec / x

    @staticmethod
    def metrics() -> List[str]:
        return ["kitti", "rmse", "chordal", "vec"]


class TransformationMetrics:
    """Translation + rotation errors and the inference time of one pair."""

    def __init__(self, translation: TranslationError, rotation: RotationError,
                 time: float):
        self.translation = translation
        self.rotation = rotation
        self.time = time

    @classmethod
    def calc(cls, pred: np.ndarray, gt: np.ndarray, time: float = 0.0) -> "TransformationMetrics":
        return cls(TranslationError.calc(pred, gt), RotationError.calc(pred, gt), time)


class SegmentMetrics:
    """KITTI segment errors, optionally normalized by segment length."""

    def __init__(self, translation: TranslationError, rotation: RotationError,
                 first_frame: int, segment_length: float, speed: float):
        self.translation = translation
        self.rotation = rotation
        self.first_frame = first_frame
        self.segment_length = segment_length
        self.speed = speed

    @classmethod
    def calc(cls, pred: np.ndarray, gt: np.ndarray, first_frame: int,
             segment_length: float, speed: float, normalize: bool) -> "SegmentMetrics":
        translation = TranslationError.calc(pred, gt)
        rotation = RotationError.calc(pred, gt)
        if normalize and segment_length > 0:
            translation.divide(segment_length)
            rotation.divide(segment_length)
        return cls(translation, rotation, first_frame, segment_length, speed)


_Metrics = Union[TransformationMetrics, SegmentMetrics]


def _stats(func: Callable, arrs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: func(v) for k, v in arrs.items()}


class MetricsContainer:
    """A sequence of metrics with min/max/mean/median/std accumulations."""

    def __init__(self, data: Seq[_Metrics]):
        self.data = list(data)

        if not self.data:
            # empty container (e.g. trajectory shorter than every KITTI
            # segment length): all statistics are NaN
            nan_t = TranslationError(np.nan, np.nan, np.full(3, np.nan))
            nan_r = RotationError(np.nan, np.nan, np.nan, np.full(3, np.nan))
            for stat in ("min", "max", "mean", "median", "std"):
                setattr(self, stat,
                        TransformationMetrics(nan_t, nan_r, np.nan))
            return

        trans = {m: np.array([getattr(x.translation, m) for x in self.data])
                 for m in TranslationError.metrics()}
        rot = {m: np.array([getattr(x.rotation, m) for x in self.data])
               for m in RotationError.metrics()}
        times = np.array([
            x.time if isinstance(x, TransformationMetrics) else 0.0
            for x in self.data
        ])

        for stat, func in (
            ("min", lambda x: np.min(x, axis=0)),
            ("max", lambda x: np.max(x, axis=0)),
            ("mean", lambda x: np.mean(x, axis=0)),
            ("median", lambda x: np.median(x, axis=0)),
            ("std", lambda x: np.std(x, axis=0)),
        ):
            setattr(self, stat, TransformationMetrics(
                TranslationError(**_stats(func, trans)),
                RotationError(**_stats(func, rot)),
                func(times),
            ))

    def __getitem__(self, i):
        return self.data[i]

    def __iter__(self):
        return iter(self.data)

    def __len__(self):
        return len(self.data)
