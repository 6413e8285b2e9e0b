"""Evaluation of predicted transformations.

    python -m deepclr_tpu_torch.evaluation RUN_DIR                  # one run
    python -m deepclr_tpu_torch.evaluation BASE_DIR --scenario NAME # every run of a scenario

Single-run mode reads RUN_DIR/scenario.yaml and the run's sequence files
(what ``python -m deepclr_tpu_torch.inference`` and ``.icp`` write) and
writes RUN_DIR/evaluation/step_errors.csv and, for a sequential scenario,
segment_errors.csv with the figures (segment_errors.png/.pdf and the
plot_eot, plot_error, plot_path, plot_path2d directories).  Multi-run mode
evaluates every run directory under BASE_DIR whose scenario is NAME and
writes BASE_DIR/evaluation/NAME/NAME_{step,segment}_errors.csv, one row a
run.

Needs neither pandas nor matplotlib: the tables are written with the
standard library, byte for byte as pandas' ``DataFrame.to_csv(index=False)``
writes them (floats as their shortest repr, NaN as an empty field), and the
figures only when matplotlib imports (the log says once when they are
skipped).
"""
from __future__ import annotations

import argparse
import csv
import math
import os
import os.path as osp
import warnings
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..config import Config
from ..utils.logging import create_logger
from .evaluator import Evaluator
from .metrics import MetricsContainer
from .scenario import load_scenario

__all__ = ["evaluate_multi", "evaluate_single", "get_error_dict", "main", "write_csv"]

SAVEFIG_ARGS = {"bbox_inches": "tight", "pad_inches": 0}
_figures_skipped = False


def load_scenario_from_dir(directory: str) -> Optional[Config]:
    scenario_file = osp.join(directory, "scenario.yaml")
    if not osp.isfile(scenario_file):
        return None
    try:
        return load_scenario(scenario_file, with_method=True)
    except RuntimeError:
        warnings.warn(f"Scenario invalid: '{scenario_file}'")
        return None


def create_dir(*args: str) -> str:
    directory = osp.join(*args)
    os.makedirs(directory, exist_ok=True)
    return directory


def _csv_field(value: Any) -> str:
    if isinstance(value, str):
        return value
    value = float(value)
    return "" if math.isnan(value) else repr(value)


def write_csv(rows: List[Dict[str, Any]], filename: str) -> None:
    """Rows of one table as pandas' ``DataFrame.from_dict(rows).to_csv(
    index=False)`` writes them: the columns in order of first appearance,
    minimal quoting, '\\n' line ends."""
    columns: List[str] = []
    for row in rows:
        columns.extend(k for k in row if k not in columns)
    with open(filename, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for row in rows:
            writer.writerow([_csv_field(row[c]) if c in row else "" for c in columns])


def get_error_dict(name: str, error: MetricsContainer, with_time: bool, method: Optional[str] = None,
                   params: Optional[str] = None, is_normalized: bool = False) -> OrderedDict:
    data: List[Tuple[str, Any]] = [("name", name)]
    if method is not None:
        data.append(("method", method))
    if params is not None:
        data.append(("params", params))

    if is_normalized:
        t_factor, t_unit, r_unit = 100, "%", "deg/m"
    else:
        t_factor, t_unit, r_unit = 1, "m", "deg"

    data.extend([
        (f"t_kitti_mean [{t_unit}]", error.mean.translation.kitti * t_factor),
        (f"t_kitti_std [{t_unit}]", error.std.translation.kitti * t_factor),
        (f"t_kitti_max [{t_unit}]", error.max.translation.kitti * t_factor),
        (f"t_rmse_mean [{t_unit}]", error.mean.translation.rmse * t_factor),
        (f"t_rmse_std [{t_unit}]", error.std.translation.rmse * t_factor),
        (f"t_rmse_max [{t_unit}]", error.max.translation.rmse * t_factor),
        (f"r_kitti_mean [{r_unit}]", np.rad2deg(error.mean.rotation.kitti)),
        (f"r_kitti_std [{r_unit}]", np.rad2deg(error.std.rotation.kitti)),
        (f"r_kitti_max [{r_unit}]", np.rad2deg(error.max.rotation.kitti)),
        (f"r_rmse_mean [{r_unit}]", np.rad2deg(error.mean.rotation.rmse)),
        (f"r_rmse_std [{r_unit}]", np.rad2deg(error.std.rotation.rmse)),
        (f"r_rmse_max [{r_unit}]", np.rad2deg(error.max.rotation.rmse)),
        (f"r_chordal_mean [{r_unit}]", np.rad2deg(error.mean.rotation.chordal)),
        (f"r_chordal_std [{r_unit}]", np.rad2deg(error.std.rotation.chordal)),
        (f"r_chordal_max [{r_unit}]", np.rad2deg(error.max.rotation.chordal)),
    ])
    if with_time:
        data.extend([
            ("time_mean [ms]", error.mean.time),
            ("time_std [ms]", error.std.time),
            ("time_max [ms]", error.max.time),
        ])
    return OrderedDict(data)


def _have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _write_figures(evaluator: Evaluator, output_dir: str) -> None:
    global _figures_skipped
    if not _have_matplotlib():
        if not _figures_skipped:
            create_logger("evaluation").info("matplotlib does not import: the evaluation figures are skipped")
            _figures_skipped = True
        return
    fig_bars = evaluator.plot_segment_error_bars()
    fig_bars.savefig(osp.join(output_dir, "segment_errors.png"), **SAVEFIG_ARGS)
    fig_bars.savefig(osp.join(output_dir, "segment_errors.pdf"), **SAVEFIG_ARGS)
    for dirname, figures in (("plot_eot", evaluator.plot_error_over_time()),
                             ("plot_error", evaluator.plot_kitti_errors()),
                             ("plot_path", evaluator.plot_sequences()),
                             ("plot_path2d", evaluator.plot_sequences_2d())):
        fig_dir = create_dir(output_dir, dirname)
        for name, fig in figures.items():
            fig.savefig(osp.join(fig_dir, f"{name}.png"), **SAVEFIG_ARGS)
            fig.savefig(osp.join(fig_dir, f"{name}.pdf"), **SAVEFIG_ARGS)


def evaluate_single(base_path: str, scenario: Config) -> Evaluator:
    evaluator = Evaluator.read(base_path, [f"{k}.txt" for k in scenario.data.keys()])
    output_dir = create_dir(base_path, "evaluation")

    step_errors = [get_error_dict(name, err, with_time=True, is_normalized=False)
                   for name, err in evaluator.get_step_errors().items()]
    step_errors.append(get_error_dict("TOTAL", evaluator.get_total_step_errors(), with_time=True,
                                      is_normalized=False))
    write_csv(step_errors, osp.join(output_dir, "step_errors.csv"))

    if scenario.sequential:
        segment_errors = [get_error_dict(name, err, with_time=False, is_normalized=True)
                          for name, err in evaluator.get_segment_errors().items()]
        segment_errors.append(get_error_dict("TOTAL", evaluator.get_total_segment_errors(), with_time=False,
                                             is_normalized=True))
        write_csv(segment_errors, osp.join(output_dir, "segment_errors.csv"))
        _write_figures(evaluator, output_dir)
    return evaluator


def evaluate_multi(base_path: str, scenario_name: str) -> None:
    step_errors = []
    segment_errors = []
    found = False

    for dirname in sorted(os.listdir(base_path)):
        directory = osp.join(base_path, dirname)
        if not osp.isdir(directory):
            continue
        scenario = load_scenario_from_dir(directory)
        if scenario is None or scenario.name != scenario_name:
            continue
        found = True

        evaluator = evaluate_single(directory, scenario)
        method_params = scenario.method.params.to_dict() if hasattr(scenario.method.params, "to_dict") else {}
        params_str = ", ".join(f"{k}={v}" for k, v in method_params.items())

        step_errors.append(get_error_dict(dirname, evaluator.get_total_step_errors(), with_time=True,
                                          method=scenario.method.name, params=params_str, is_normalized=False))
        if scenario.sequential:
            segment_errors.append(get_error_dict(dirname, evaluator.get_total_segment_errors(), with_time=False,
                                                 method=scenario.method.name, params=params_str,
                                                 is_normalized=True))

    if not found:
        warnings.warn(f"No evaluation found for scenario '{scenario_name}'")
        return

    out = create_dir(base_path, "evaluation", scenario_name)
    if step_errors:
        write_csv(step_errors, osp.join(out, f"{scenario_name}_step_errors.csv"))
    if segment_errors:
        write_csv(segment_errors, osp.join(out, f"{scenario_name}_segment_errors.csv"))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Run evaluation on predicted transformations.")
    parser.add_argument("path", type=str, help="direct or base directory of inference or icp output")
    parser.add_argument("--scenario", type=str, default=None, help="evaluation scenario")
    args = parser.parse_args(argv)

    if args.scenario is None:
        scenario = load_scenario_from_dir(args.path)
        if scenario is not None:
            evaluate_single(args.path, scenario)
    else:
        evaluate_multi(args.path, args.scenario)
