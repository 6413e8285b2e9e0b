"""ICP registration for an evaluation scenario.

    python -m deepclr_tpu_torch.icp SCENARIO.yaml {icp_po2po,icp_po2pl,gicp} OUTPUT_BASE \
        [--max-distance 1.0] [--neighbor-radius 1.0] [--max-nn 30] [--max-iterations 100] \
        [--epsilon 1e-3] [--device cuda|cpu]

Registers every data file of the scenario and writes
OUTPUT_BASE/{stamp}_{scenario}_{ALGORITHM}/ with ``scenario.yaml`` (its
``method`` entry filled in) and one 26-column text file per sequence, which
``python -m deepclr_tpu_torch.evaluation`` scores: the layout of the model
inference CLI.  A sequential scenario reuses each prepared source as the
next pair's template.  A pair's recorded time runs from its clouds on the
host to its transform on the host.  Runs on CUDA unless ``--device cpu``.
``run`` does the work from a scenario ``Config``; ``main`` also reads the
scenario YAML.
"""
from __future__ import annotations

import argparse
import logging
import os
import os.path as osp
import time
from datetime import datetime
from typing import List, Optional

import numpy as np

from ..data import create_input_dataflow
from ..evaluation import Evaluator, load_scenario
from ..utils.logging import create_logger
from .icp import ICPAlgorithm, ICPRegistration

__all__ = ["main", "run", "run_scenario"]


def run_scenario(scene_cfg, registration: ICPRegistration, logger: Optional[logging.Logger] = None,
                 infos: Optional[List[dict]] = None) -> Evaluator:
    """Register every data file of ``scene_cfg`` (a scenario ``Config``);
    returns the Evaluator holding the predictions, ground truth and times.
    With ``infos`` (a list) each pair's ``register`` info is appended."""
    logger = logger or create_logger("evaluation")
    evaluator = Evaluator()
    for data_name, data_file in scene_cfg.data.items():
        logger.info(f"Evaluate '{data_file}'")
        df = create_input_dataflow(scene_cfg.dataset_type, data_file, shuffle=False)
        prev_prepared = None
        for i, ds in enumerate(df):
            if (i + 1) % 10 == 0:
                logger.info(f"Data point {i + 1}/{len(df)}")
            t0 = time.perf_counter()
            if scene_cfg.sequential and prev_prepared is not None:
                template = prev_prepared
            else:
                template = registration.prepare(ds["clouds"][0][:, :3])
            source = registration.prepare(ds["clouds"][1][:, :3])
            m, info = registration.register(template, source, return_info=True)
            t_pred_ms = (time.perf_counter() - t0) * 1000.0
            prev_prepared = source
            if infos is not None:
                infos.append(info)
            evaluator.add_transforms(str(data_name), float(np.ravel(ds["timestamps"][0])[0]), m,
                                     ds["transform"], t_pred_ms)
    return evaluator


def run(scene_cfg, algorithm, output_base: str, max_distance: float = 1.0, neighbor_radius: float = 1.0,
        max_nn: int = 30, max_iterations: int = 100, epsilon: float = 1e-3, device="cuda",
        logger: Optional[logging.Logger] = None, infos: Optional[List[dict]] = None) -> str:
    """Register the scenario with ``algorithm`` and write the run directory;
    returns its path."""
    import yaml

    logger = logger or create_logger("evaluation")
    algorithm = ICPAlgorithm.create(algorithm)
    params = {"max_distance": max_distance, "neighbor_radius": neighbor_radius, "max_nn": max_nn,
              "max_iterations": max_iterations, "epsilon": epsilon}
    registration = ICPRegistration(algorithm, device=device, **params)

    output_stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    output_dir = osp.join(output_base, f"{output_stamp}_{scene_cfg.name}_{algorithm.name}")
    os.makedirs(output_dir, exist_ok=True)
    eval_cfg = scene_cfg.to_dict()
    eval_cfg["method"] = {"name": algorithm.name, "params": params}
    with open(osp.join(output_dir, "scenario.yaml"), "w") as f:
        yaml.dump(eval_cfg, f, default_flow_style=False, sort_keys=False)

    evaluator = run_scenario(scene_cfg, registration, logger, infos)
    logger.info("Store results")
    evaluator.write(output_dir)
    return output_dir


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="ICP registration for evaluation scenario.")
    parser.add_argument("scenario", type=str, help="scenario configuration (*.yaml)")
    parser.add_argument("algorithm", type=str, choices=[a.value for a in ICPAlgorithm], help="ICP algorithm type")
    parser.add_argument("output_base", type=str, help="base directory for inference output")
    parser.add_argument("--max-distance", type=float, default=1.0,
                        help="maximal distance for ICP (default: 1.0)")
    parser.add_argument("--neighbor-radius", type=float, default=1.0,
                        help="neighbor radius (e.g. for ICP plane) (default: 1.0)")
    parser.add_argument("--max-nn", type=int, default=30, help="maximal number of neighbors (default: 30)")
    parser.add_argument("--max-iterations", type=int, default=100, help="ICP outer iteration cap (default: 100)")
    parser.add_argument("--epsilon", type=float, default=1e-3,
                        help="convergence threshold on the transform update (default: 1e-3)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    logger = create_logger("evaluation")
    logger.info("Loading scenario")
    scene_cfg = load_scenario(args.scenario, with_method=False)
    return run(scene_cfg, args.algorithm, args.output_base, max_distance=args.max_distance,
               neighbor_radius=args.neighbor_radius, max_nn=args.max_nn, max_iterations=args.max_iterations,
               epsilon=args.epsilon, device=args.device, logger=logger)
