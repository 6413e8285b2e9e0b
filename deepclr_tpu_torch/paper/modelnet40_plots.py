"""ModelNet40 error-against-noise curves (scripts/paper/modelnet40_plots.py):

    python -m deepclr_tpu_torch.paper.modelnet40_plots PATH [--output DIR]

For each method with a run directory under PATH of scenario
``modelnet40_unseen``: the mean chordal rotation error [deg] and KITTI
translation error [m] on each dataset ``test_unseen_{noise:0.2f}``, noise
0.00-0.10; written as modelnet40_{rotation,translation}_vs_noise.{png,pdf}
into DIR (default PATH/evaluation).  ``curves`` computes them without
matplotlib; the plots need it (Agg backend)."""
from __future__ import annotations

import argparse
import os
import os.path as osp
import warnings
from typing import Dict, List

import numpy as np

from ..config import Config
from ..utils.pcv import require_pyplot
from ._runs import read_run, scenario_runs

SCENARIO_NAME = "modelnet40_unseen"
DATASET_NAME_TEMPLATE = "test_unseen_{noise:0.2f}"
NOISE_LEVELS = [0.00, 0.01, 0.02, 0.03, 0.04, 0.05, 0.06, 0.07, 0.08, 0.09, 0.10]


def evaluate(path: str, scenario: Config) -> Dict[str, List[float]]:
    step_errors = read_run(path, scenario).get_step_errors()
    rot, trans = [], []
    for noise in NOISE_LEVELS:
        name = DATASET_NAME_TEMPLATE.format(noise=noise)
        if name not in step_errors:
            raise RuntimeError(f"Dataset '{name}' not found for method '{scenario.method.name}'")
        rot.append(np.rad2deg(step_errors[name].mean.rotation.chordal))
        trans.append(step_errors[name].mean.translation.kitti)
    return {"rotation": rot, "translation": trans}


def curves(path: str) -> Dict[str, Dict[str, List[float]]]:
    """{method: {"rotation": [...], "translation": [...]}} over NOISE_LEVELS,
    for every run directory under ``path`` of the scenario (a later run of a
    method replaces an earlier one, as in the script)."""
    return {scenario.method.name: evaluate(directory, scenario)
            for directory, scenario in scenario_runs(path, SCENARIO_NAME)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Plot ModelNet40 error-vs-noise curves.")
    parser.add_argument("path", type=str, help="base directory of inference output")
    parser.add_argument("--output", type=str, default=None, help="output directory (default: PATH/evaluation)")
    args = parser.parse_args(argv)

    plt = require_pyplot("Agg")
    data = curves(args.path)
    if not data:
        warnings.warn("Could not find scenario.")
        return

    out_dir = args.output or osp.join(args.path, "evaluation")
    os.makedirs(out_dir, exist_ok=True)
    for metric, ylabel, fname in (
        ("rotation", "rotation error [deg]", "modelnet40_rotation_vs_noise"),
        ("translation", "translation error [m]", "modelnet40_translation_vs_noise"),
    ):
        fig, ax = plt.subplots()
        for method, values in data.items():
            ax.plot(NOISE_LEVELS, values[metric], "o-", label=method)
        ax.set_xlabel("noise sigma [m]")
        ax.set_ylabel(ylabel)
        ax.legend()
        fig.savefig(osp.join(out_dir, f"{fname}.png"), bbox_inches="tight")
        fig.savefig(osp.join(out_dir, f"{fname}.pdf"), bbox_inches="tight")
        plt.close(fig)
    print(f"Plots written to {out_dir}")


if __name__ == "__main__":
    main()
