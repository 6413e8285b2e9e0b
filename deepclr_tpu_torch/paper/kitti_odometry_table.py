"""The KITTI odometry table (scripts/paper/kitti_odometry_table.py):

    python -m deepclr_tpu_torch.paper.kitti_odometry_table PATH

finds the first run directory under PATH (sorted) of scenario
``kitti_04_10`` and method ``DEEPCLR`` and prints its per-sequence
translation and rotation RMSE and the mean inference time."""
from __future__ import annotations

import argparse
import warnings

import numpy as np

from ..config import Config
from ._runs import print_table, read_run, scenario_runs

SCENARIO_NAME = "kitti_04_10"
METHOD_NAME = "DEEPCLR"


def evaluate(path: str, scenario: Config) -> None:
    evaluator = read_run(path, scenario)
    step_errors = evaluator.get_step_errors()
    total = evaluator.get_total_step_errors()

    data = {
        seq: {
            "t_rmse [m]": metrics.mean.translation.rmse,
            "r_rmse [deg]": np.rad2deg(metrics.mean.rotation.rmse),
        }
        for seq, metrics in step_errors.items()
    }
    print("== DeepCLR Results on KITTI Odometry ==")
    print_table(data)
    print()
    print(f"Average Inference Time: {total.mean.time:.2f} ms")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Print table for KITTI odometry evaluation.")
    parser.add_argument("path", type=str, help="base directory of inference output")
    args = parser.parse_args(argv)

    for directory, scenario in scenario_runs(args.path, SCENARIO_NAME):
        if scenario.method.name == METHOD_NAME:
            evaluate(directory, scenario)
            return
    warnings.warn("Could not find scenario.")


if __name__ == "__main__":
    main()
