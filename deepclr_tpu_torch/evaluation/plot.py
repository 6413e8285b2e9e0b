"""Evaluation plots (matplotlib, host-side, Agg backend).

Trajectory paths (3D + 2D birds-eye), per-step error over time, KITTI error
vs. segment length / speed, and segment error bars per sequence.  Only the
``Evaluator.plot_*`` methods import this module, so scoring a run needs no
matplotlib.
"""
from __future__ import annotations

from typing import Dict

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

from .data import Sequence  # noqa: E402
from .metrics import MetricsContainer  # noqa: E402

__all__ = [
    "plot_sequence",
    "plot_sequence_2d",
    "plot_error_over_time",
    "plot_kitti_errors",
    "plot_segment_error_bars",
]


def plot_sequence(sequence: Sequence):
    """3D trajectory plot: prediction vs ground truth."""
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    for motion, label in ((sequence.ground_truth, "ground truth"),
                          (sequence.prediction, "prediction")):
        path = motion.get_path()
        ax.plot(path[:, 0], path[:, 1], path[:, 2], label=label)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    ax.legend()
    return fig


def plot_sequence_2d(sequence: Sequence):
    """Birds-eye (x/y) trajectory plot."""
    fig, ax = plt.subplots()
    for motion, label in ((sequence.ground_truth, "ground truth"),
                          (sequence.prediction, "prediction")):
        path = motion.get_path()
        ax.plot(path[:, 0], path[:, 1], label=label)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_aspect("equal")
    ax.legend()
    return fig


def plot_error_over_time(step_errors: MetricsContainer):
    """Per-step translation / rotation error over the sequence."""
    t_err = [x.translation.kitti for x in step_errors]
    r_err = [np.rad2deg(x.rotation.kitti) for x in step_errors]
    fig, (ax1, ax2) = plt.subplots(2, 1, sharex=True)
    ax1.plot(t_err)
    ax1.set_ylabel("translation error [m]")
    ax2.plot(r_err)
    ax2.set_ylabel("rotation error [deg]")
    ax2.set_xlabel("frame")
    return fig


def plot_kitti_errors(segment_errors: MetricsContainer):
    """KITTI-style error vs. segment length and vs. speed (averaged bins)."""
    lengths = np.array([x.segment_length for x in segment_errors])
    speeds = np.array([x.speed for x in segment_errors])
    t_err = np.array([x.translation.kitti for x in segment_errors]) * 100.0
    r_err = np.rad2deg(np.array([x.rotation.kitti for x in segment_errors]))

    fig, axes = plt.subplots(2, 2, figsize=(10, 8))

    def binned(ax, keys, values, xlabel, ylabel):
        uniq = np.unique(keys)
        means = [values[keys == u].mean() for u in uniq]
        ax.plot(uniq, means, "o-")
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)

    binned(axes[0, 0], lengths, t_err, "segment length [m]", "translation error [%]")
    binned(axes[0, 1], lengths, r_err, "segment length [m]", "rotation error [deg/m]")
    speed_bins = (speeds // 5.0) * 5.0
    binned(axes[1, 0], speed_bins, t_err, "speed [m/s]", "translation error [%]")
    binned(axes[1, 1], speed_bins, r_err, "speed [m/s]", "rotation error [deg/m]")
    fig.tight_layout()
    return fig


def plot_segment_error_bars(segment_errors: Dict[str, MetricsContainer]):
    """Mean segment errors per sequence as bar charts."""
    names = list(segment_errors.keys())
    t_means = [c.mean.translation.kitti * 100.0 for c in segment_errors.values()]
    r_means = [np.rad2deg(c.mean.rotation.kitti) for c in segment_errors.values()]

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    x = np.arange(len(names))
    ax1.bar(x, t_means)
    ax1.set_xticks(x, names, rotation=45)
    ax1.set_ylabel("translation error [%]")
    ax2.bar(x, r_means)
    ax2.set_xticks(x, names, rotation=45)
    ax2.set_ylabel("rotation error [deg/m]")
    fig.tight_layout()
    return fig
