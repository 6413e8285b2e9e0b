"""Plot artifacts for the KITTI odometry devkit evaluation.

The reference devkit writes gnuplot path and error plots next to its error
tables (reference extern/kitti_devkit.patch:28-60: per-sequence trajectory
plots plus translation/rotation error over path length and speed, and the
same four plots averaged over all evaluated sequences).  This reproduces
those artifacts with matplotlib from the files the native evaluator
(csrc/host/kitti_devkit.cpp) already emits:

  result_dir/errors_<seq>.txt   rows: first_frame r_err t_err len speed
  pred_dir/<seq>.txt            12-col KITTI pose rows (also gt_dir)

Outputs into result_dir: <seq>_path.png, <seq>_{tl,rl,ts,rs}.png and
avg_{tl,rl,ts,rs}.png.
"""
from __future__ import annotations

import os.path as osp
from glob import glob
from typing import List, Optional

import numpy as np

__all__ = ["write_plots"]

_LENGTHS = [100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0]


def _load_poses(path: str) -> np.ndarray:
    data = np.loadtxt(path).reshape(-1, 12)
    return data.reshape(-1, 3, 4)


def _plot_path(ax, gt, pred, seq: str):
    ax.plot(gt[:, 0, 3], gt[:, 2, 3], "-", color="#d62728", label="Ground Truth")
    ax.plot(pred[:, 0, 3], pred[:, 2, 3], "-", color="#1f77b4",
            label="Visual Odometry")
    ax.scatter([gt[0, 0, 3]], [gt[0, 2, 3]], marker="s", color="black",
               label="Sequence Start", zorder=3)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(f"Sequence {seq}")
    ax.axis("equal")
    ax.legend(loc="best", fontsize=8)


def _binned(errors: np.ndarray, key_col: int, err_col: int, bins):
    """Mean of errors[:, err_col] for rows whose key matches each bin."""
    xs, ys = [], []
    for i, b in enumerate(bins):
        if key_col == 3:  # exact segment lengths
            sel = errors[:, key_col] == b
        else:  # speed buckets of 2 m/s around b
            sel = (errors[:, key_col] >= b - 1.0) & (errors[:, key_col] < b + 1.0)
        if sel.any():
            xs.append(b)
            ys.append(float(errors[sel, err_col].mean()))
    return np.asarray(xs), np.asarray(ys)


def _plot_error(ax, xs, ys, xlabel: str, ylabel: str):
    ax.plot(xs, ys, "-s", color="#1f77b4", label="Translation Error"
            if "%" in ylabel else "Rotation Error")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(True, alpha=0.3)
    ax.legend(loc="best", fontsize=8)


def _error_plots(errors: np.ndarray, prefix: str, result_dir: str, plt):
    speeds = np.arange(2.0, 26.0, 2.0)
    panels = [
        ("tl", 3, 2, _LENGTHS, "Path Length [m]", "Translation Error [%]",
         100.0),
        ("rl", 3, 1, _LENGTHS, "Path Length [m]", "Rotation Error [deg/m]",
         np.degrees(1.0)),
        ("ts", 4, 2, speeds, "Speed [km/h]", "Translation Error [%]", 100.0),
        ("rs", 4, 1, speeds, "Speed [km/h]", "Rotation Error [deg/m]",
         np.degrees(1.0)),
    ]
    for name, key_col, err_col, bins, xlabel, ylabel, scale in panels:
        xs, ys = _binned(errors, key_col, err_col, bins)
        if xs.size == 0:
            continue
        if name in ("ts", "rs"):
            xs = xs * 3.6  # m/s -> km/h
        fig, ax = plt.subplots(figsize=(5, 4))
        _plot_error(ax, xs, ys * scale, xlabel, ylabel)
        fig.tight_layout()
        fig.savefig(osp.join(result_dir, f"{prefix}_{name}.png"), dpi=110)
        plt.close(fig)


def write_plots(gt_dir: str, pred_dir: str,
                result_dir: Optional[str] = None) -> List[str]:
    """Generate the devkit's plot set; returns the sequence names plotted.
    Imports matplotlib here, so the package imports without it."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    result_dir = result_dir or osp.join(pred_dir, "result")
    seqs = []
    all_errors = []
    for err_file in sorted(glob(osp.join(result_dir, "errors_*.txt"))):
        seq = osp.basename(err_file)[len("errors_"):-len(".txt")]
        errors = np.loadtxt(err_file).reshape(-1, 5)
        all_errors.append(errors)
        seqs.append(seq)

        gt_file = osp.join(gt_dir, f"{seq}.txt")
        pred_file = osp.join(pred_dir, f"{seq}.txt")
        if osp.exists(gt_file) and osp.exists(pred_file):
            fig, ax = plt.subplots(figsize=(5, 5))
            _plot_path(ax, _load_poses(gt_file), _load_poses(pred_file), seq)
            fig.tight_layout()
            fig.savefig(osp.join(result_dir, f"{seq}_path.png"), dpi=110)
            plt.close(fig)

        _error_plots(errors, seq, result_dir, plt)

    if all_errors:
        _error_plots(np.concatenate(all_errors), "avg", result_dir, plt)
    return seqs
