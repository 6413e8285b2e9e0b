"""The unseen-shapes ModelNet40 table at noise 0.04
(scripts/paper/modelnet40_table.py):

    python -m deepclr_tpu_torch.paper.modelnet40_table PATH

prints one row a method of the run directories under PATH of scenario
``modelnet40_unseen``, from their dataset ``test_unseen_0.04``: chordal
rotation error and KITTI translation error, mean and std, and the mean
time."""
from __future__ import annotations

import argparse
import warnings
from typing import Dict, Optional

import numpy as np

from ..config import Config
from ._runs import print_table, read_run, scenario_runs

SCENARIO_NAME = "modelnet40_unseen"
DATASET_NAME = "test_unseen_0.04"


def evaluate(path: str, scenario: Config) -> Optional[Dict]:
    step_errors = read_run(path, scenario).get_step_errors()
    if DATASET_NAME not in step_errors:
        warnings.warn("Dataset not found in scenario.")
        return None
    metrics = step_errors[DATASET_NAME]
    return {
        "Rot. Error Mean [deg]": np.rad2deg(metrics.mean.rotation.chordal),
        "Rot. Error Std [deg]": np.rad2deg(metrics.std.rotation.chordal),
        "Tran. Error Mean [m]": metrics.mean.translation.kitti,
        "Tran. Error Std [m]": metrics.std.translation.kitti,
        "Time [ms]": metrics.mean.time,
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Print table for ModelNet40 evaluation.")
    parser.add_argument("path", type=str, help="base directory of inference output")
    args = parser.parse_args(argv)

    data = {}
    for directory, scenario in scenario_runs(args.path, SCENARIO_NAME):
        scenario_data = evaluate(directory, scenario)
        if scenario_data is not None:
            data[scenario.method.name] = scenario_data

    if not data:
        warnings.warn("Could not find scenario.")
    else:
        print(f"== DeepCLR Results on Unseen ModelNet40 Data ({DATASET_NAME}) ==")
        print_table(data)


if __name__ == "__main__":
    main()
