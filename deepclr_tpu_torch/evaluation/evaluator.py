"""Evaluator: accumulate named sequences, compute step + KITTI segment errors.

The KITTI odometry segment protocol: every ``STEP_SIZE``-th frame x segment
lengths 100..800 m, errors normalized by segment length.  The plot methods
import matplotlib (``plot.py``) when called.
"""
from __future__ import annotations

import os
import os.path as osp
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from .data import Sequence, rigid_inverse as _rigid_inverse
from .metrics import MetricsContainer, SegmentMetrics, TransformationMetrics

__all__ = ["Evaluator", "STEP_SIZE", "SEGMENT_LENGTHS"]

STEP_SIZE = 10  # every second at 10 Hz
SEGMENT_LENGTHS = [100, 200, 300, 400, 500, 600, 700, 800]


def _step_errors(sequence: Sequence) -> List[TransformationMetrics]:
    return [
        TransformationMetrics.calc(p, g, t)
        for p, g, t in zip(sequence.prediction.transforms,
                           sequence.ground_truth.transforms, sequence.times)
    ]


def _segment_errors(sequence: Sequence, step_size: int = STEP_SIZE,
                    segment_lengths: Optional[List[int]] = None) -> List[SegmentMetrics]:
    """KITTI odometry segment protocol."""
    assert len(sequence.prediction.poses) == len(sequence.ground_truth.poses)
    if segment_lengths is None:
        segment_lengths = SEGMENT_LENGTHS

    gt = sequence.ground_truth
    pred = sequence.prediction
    errors: List[SegmentMetrics] = []
    for first in range(0, len(gt.poses), step_size):
        for seg_len in segment_lengths:
            last = gt.get_frame_by_distance(first, seg_len)
            if last == -1:
                continue
            if seg_len == 0:
                seg_len = gt.distances[last] - gt.distances[first]
            num_frames = last - first + 1
            speed = seg_len / (0.1 * num_frames)
            delta_pred = _rigid_inverse(pred.poses[first]) @ pred.poses[last]
            delta_gt = _rigid_inverse(gt.poses[first]) @ gt.poses[last]
            errors.append(SegmentMetrics.calc(
                delta_pred, delta_gt, first_frame=first,
                segment_length=seg_len, speed=speed, normalize=True,
            ))
    return errors


def _merge(errors: Dict[str, MetricsContainer]) -> MetricsContainer:
    merged: List = []
    for c in errors.values():
        merged.extend(c.data)
    return MetricsContainer(merged)


class Evaluator:
    """Store, process and visualize ground-truth and prediction sequences."""

    def __init__(self):
        self._sequences: "OrderedDict[str, Sequence]" = OrderedDict()
        self.reset_errors()

    def reset(self) -> None:
        self._sequences.clear()
        self.reset_errors()

    def reset_errors(self) -> None:
        self._step_errors = None
        self._total_step_errors = None
        self._segment_errors = None
        self._total_segment_errors = None

    def add_transforms(self, name: str, stamp: float, pred: np.ndarray,
                       gt: np.ndarray, time: float = 0.0) -> None:
        if name not in self._sequences:
            self._sequences[name] = Sequence()
        self._sequences[name].add_transforms(stamp, pred, gt, time)
        self.reset_errors()

    @classmethod
    def read(cls, path: str, filenames: Optional[List[str]] = None) -> "Evaluator":
        if filenames is None:
            files = OrderedDict(
                (osp.splitext(f)[0], osp.join(path, f))
                for f in sorted(os.listdir(path))
                if osp.isfile(osp.join(path, f)) and f.endswith(".txt")
            )
        else:
            files = OrderedDict(
                (osp.splitext(f)[0], osp.join(path, f)) for f in filenames
            )
        ev = cls()
        for name, filename in files.items():
            ev._sequences[name] = Sequence.read(filename)
        return ev

    @classmethod
    def read_separate(cls, path_pred: str, path_gt: str, has_poses: bool,
                      filenames: Optional[List[str]] = None) -> "Evaluator":
        if filenames is None:
            names = sorted(
                f for f in os.listdir(path_pred)
                if osp.isfile(osp.join(path_pred, f)) and f.endswith(".txt")
            )
        else:
            names = list(filenames)
        ev = cls()
        for f in names:
            if not osp.isfile(osp.join(path_gt, f)):
                raise RuntimeError(
                    f"Could not find ground truth file for prediction '{f}'"
                )
            ev._sequences[osp.splitext(f)[0]] = Sequence.read_separate(
                osp.join(path_pred, f), osp.join(path_gt, f), has_poses
            )
        return ev

    def write(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        for name, seq in self._sequences.items():
            seq.write(osp.join(path, f"{name}.txt"))

    # --- accessors -----------------------------------------------------------
    def has_sequence(self, name: str) -> bool:
        return name in self._sequences

    def get_sequence(self, name: str) -> Sequence:
        return self._sequences[name]

    def get_sequences(self) -> "OrderedDict[str, Sequence]":
        return self._sequences

    def get_step_errors(self) -> "OrderedDict[str, MetricsContainer]":
        if self._step_errors is None:
            self._step_errors = OrderedDict(
                (name, MetricsContainer(_step_errors(seq)))
                for name, seq in self._sequences.items()
            )
        return self._step_errors

    def get_total_step_errors(self) -> MetricsContainer:
        if self._total_step_errors is None:
            self._total_step_errors = _merge(self.get_step_errors())
        return self._total_step_errors

    def get_segment_errors(self) -> "OrderedDict[str, MetricsContainer]":
        if self._segment_errors is None:
            self._segment_errors = OrderedDict(
                (name, MetricsContainer(_segment_errors(seq)))
                for name, seq in self._sequences.items()
            )
        return self._segment_errors

    def get_total_segment_errors(self) -> MetricsContainer:
        if self._total_segment_errors is None:
            self._total_segment_errors = _merge(self.get_segment_errors())
        return self._total_segment_errors

    # --- plots ---------------------------------------------------------------
    def plot_error_over_time(self):
        from .plot import plot_error_over_time

        return OrderedDict(
            (name, plot_error_over_time(errs))
            for name, errs in self.get_step_errors().items()
        )

    def plot_kitti_errors(self):
        from .plot import plot_kitti_errors

        return OrderedDict(
            (name, plot_kitti_errors(errs))
            for name, errs in self.get_segment_errors().items()
        )

    def plot_total_kitti_errors(self):
        from .plot import plot_kitti_errors

        return plot_kitti_errors(self.get_total_segment_errors())

    def plot_segment_error_bars(self):
        from .plot import plot_segment_error_bars

        return plot_segment_error_bars(self.get_segment_errors())

    def plot_sequences(self):
        from .plot import plot_sequence

        return self._titled(plot_sequence)

    def plot_sequences_2d(self):
        from .plot import plot_sequence_2d

        return self._titled(plot_sequence_2d)

    def _titled(self, plot):
        figures = OrderedDict()
        for name, seq in self._sequences.items():
            fig = plot(seq)
            fig.suptitle(name)
            figures[name] = fig
        return figures
