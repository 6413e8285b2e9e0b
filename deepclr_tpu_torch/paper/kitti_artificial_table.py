"""The artificial KITTI pairs table, DeepVCP protocol
(scripts/paper/kitti_artificial_table.py):

    python -m deepclr_tpu_torch.paper.kitti_artificial_table PATH

prints one row a method of the run directories under PATH of scenario
``kitti_pairs``: chordal rotation error and KITTI translation error, mean
and max, and the mean time."""
from __future__ import annotations

import argparse
import warnings
from typing import Dict

import numpy as np

from ..config import Config
from ._runs import print_table, read_run, scenario_runs

SCENARIO_NAME = "kitti_pairs"


def evaluate(path: str, scenario: Config) -> Dict:
    metrics = read_run(path, scenario).get_total_step_errors()
    return {
        "Rot. Error Mean [deg]": np.rad2deg(metrics.mean.rotation.chordal),
        "Rot. Error Max [deg]": np.rad2deg(metrics.max.rotation.chordal),
        "Tran. Error Mean [m]": metrics.mean.translation.kitti,
        "Tran. Error Max [m]": metrics.max.translation.kitti,
        "Time [ms]": metrics.mean.time,
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Print table for artificial KITTI evaluation.")
    parser.add_argument("path", type=str, help="base directory of inference output")
    args = parser.parse_args(argv)

    data = {scenario.method.name: evaluate(directory, scenario)
            for directory, scenario in scenario_runs(args.path, SCENARIO_NAME)}
    if not data:
        warnings.warn("Could not find scenario.")
    else:
        print("== Results on Artificial KITTI Pairs ==")
        print_table(data)


if __name__ == "__main__":
    main()
