"""Model inference for an evaluation scenario.

    python -m deepclr_tpu_torch.inference SCENARIO.yaml MODEL_NAME OUTPUT_BASE \
        [--model_path DIR] [--weights weights.pt] [--num_points 16384] \
        [--upload_dtype float32|uint16] [--parallel_sequences N] [--device cuda|cpu]

Loads ``model_config.yaml`` and the weights (``weights.pt``, the state dict
that training writes) from MODEL_PATH/MODEL_NAME, registers every data file
of the scenario, times every prediction, and writes
OUTPUT_BASE/{stamp}_{scenario}_{MODEL_TYPE}/ with ``scenario.yaml`` (its
``method`` entry filled in) and one 26-column text file per sequence, which
``scripts/evaluation.py`` scores.  Three modes:

  * one stream at a time (sequential scenarios through the sequential
    ``ModelInferenceHelper``, pairwise ones pair by pair);
  * ``--parallel_sequences N`` on a sequential scenario: N sequences in
    lock-step through one ``BatchedSequentialHelper``; a frame's recorded
    time is the step's time over the lanes still running;
  * ``--parallel_sequences N`` on a pairwise scenario: N pairs a
    ``predict_batch`` call, the last call padded by repeating its last pair;
    a pair's recorded time is the call's over its real pairs.

The batched modes run one warm-up call outside the timed window, and on the
card every kernel is built before the first timed prediction.  Runs on CUDA
unless ``--device cpu``.  ``run_scenario`` does the work and needs no YAML
package; ``main`` reads and writes the YAML files.
"""
from __future__ import annotations

import argparse
import logging
import os
import os.path as osp
import time
from datetime import datetime
from typing import Optional

import numpy as np

from . import ops
from .data import create_input_dataflow
from .evaluation import Evaluator, load_scenario
from .geometry.hostmath import label_to_matrix_np
from .models import BatchedSequentialHelper, DeepCLR, ModelInferenceHelper, load_trained_model
from .models.base import UPLOAD_DTYPES
from .utils.logging import create_logger

__all__ = ["DEFAULT_NUM_POINTS", "main", "run_scenario"]

DEFAULT_NUM_POINTS = 16384


def _stamp(ds) -> float:
    return float(np.ravel(ds["timestamps"][0])[0])


def _run_streams(scene_cfg, helper, evaluator, label_type, logger):
    """One stream at a time: each sequence (or pair file) in turn."""
    for data_name, data_file in scene_cfg.data.items():
        logger.info(f"Evaluate '{data_file}'")
        df = create_input_dataflow(scene_cfg.dataset_type, data_file, shuffle=False)
        helper.reset_state()
        for i, ds in enumerate(df):
            if (i + 1) % 10 == 0:
                logger.info(f"Data point {i + 1}/{len(df)}")
            template, source = ds["clouds"]
            t0 = time.perf_counter()
            if scene_cfg.sequential:
                if not helper.has_state():
                    helper.predict(template)
                y_pred = helper.predict(source)
            else:
                y_pred = helper.predict(source, template)
            t_pred_ms = (time.perf_counter() - t0) * 1000.0
            evaluator.add_transforms(str(data_name), _stamp(ds), label_to_matrix_np(label_type, y_pred),
                                     ds["transform"], t_pred_ms)


def _run_parallel_sequences(scene_cfg, model, num_points, evaluator, label_type, logger,
                            max_streams, upload_dtype):
    """Up to ``max_streams`` sequences in lock-step through one
    BatchedSequentialHelper.  Predictions equal the stream-at-a-time mode's
    when the clouds fit ``num_points``; with subsampling the warm-up step
    draws the templates' subsamples a second time."""
    items = list(scene_cfg.data.items())
    # one helper per lane count, as the JAX script keeps one compiled
    # program per shape: a group reuses the RNG streams of the last group
    # of its size, so both packages draw the same subsamples
    helpers = {}
    for g0 in range(0, len(items), max_streams):
        iters, current, group = [], [], []
        for name, data_file in items[g0:g0 + max_streams]:
            it = iter(create_input_dataflow(scene_cfg.dataset_type, data_file, shuffle=False))
            try:
                first = next(it)
            except StopIteration:
                logger.warning(f"'{data_file}' yields no pairs; skipping")
                continue
            iters.append(it)
            current.append(first)
            group.append((name, data_file))
        b_dim = len(group)
        if b_dim == 0:
            continue
        logger.info("Evaluate " + ", ".join(f"'{f}'" for _, f in group) + f" ({b_dim} parallel streams)")
        if b_dim not in helpers:
            helpers[b_dim] = BatchedSequentialHelper(model, batch=b_dim, num_points=num_points,
                                                     upload_dtype=upload_dtype)
        helper = helpers[b_dim]
        helper.reset_all()

        clouds = [ds["clouds"][0] for ds in current]
        helper.step(clouds)  # seed every lane's state with its template
        helper.step(clouds)  # warm-up of the fused step, outside the timed loop
        active = [True] * b_dim
        step = 0
        while any(active):
            for b in range(b_dim):
                if active[b]:
                    # a finished lane keeps its last cloud: it still
                    # computes, but nothing is recorded for it
                    clouds[b] = current[b]["clouds"][1]
            t0 = time.perf_counter()
            preds = helper.step(clouds)
            t_share_ms = (time.perf_counter() - t0) * 1000.0 / max(1, sum(active))
            for b in range(b_dim):
                if not active[b]:
                    continue
                ds = current[b]
                evaluator.add_transforms(str(group[b][0]), _stamp(ds), label_to_matrix_np(label_type, preds[b]),
                                         ds["transform"], t_share_ms)
                try:
                    current[b] = next(iters[b])
                except StopIteration:
                    active[b] = False
            step += 1
            if step % 10 == 0:
                logger.info(f"Step {step} ({sum(active)}/{b_dim} streams active)")


def _run_batched_pairwise(scene_cfg, helper, evaluator, label_type, logger, batch):
    """B pairs a predict_batch call; the tail chunk repeats its last pair
    (the extra lanes are discarded)."""
    warmed = False
    for data_name, data_file in scene_cfg.data.items():
        logger.info(f"Evaluate '{data_file}' (batched pairwise, B={batch})")
        df = create_input_dataflow(scene_cfg.dataset_type, data_file, shuffle=False)
        pending = []
        it = iter(df)
        done = False
        n_done = 0
        while not done:
            try:
                pending.append(next(it))
            except StopIteration:
                done = True
            if len(pending) == batch or (done and pending):
                real = len(pending)
                chunk = pending + [pending[-1]] * (batch - real)
                pending = []
                templates = [ds["clouds"][0] for ds in chunk]
                sources = [ds["clouds"][1] for ds in chunk]
                if not warmed:
                    helper.predict_batch(sources, templates)
                    warmed = True
                t0 = time.perf_counter()
                preds = helper.predict_batch(sources, templates)
                t_share_ms = (time.perf_counter() - t0) * 1000.0 / real
                for b in range(real):
                    ds = chunk[b]
                    evaluator.add_transforms(str(data_name), _stamp(ds), label_to_matrix_np(label_type, preds[b]),
                                             ds["transform"], t_share_ms)
                n_done += real
                if (n_done // batch) % 10 == 0:
                    logger.info(f"Data point {n_done}/{len(df)}")


def run_scenario(scene_cfg, model: DeepCLR, num_points: int = DEFAULT_NUM_POINTS,
                 upload_dtype: str = "float32", parallel: int = 1,
                 logger: Optional[logging.Logger] = None) -> Evaluator:
    """Register every data file of ``scene_cfg`` (a scenario ``Config``,
    from ``load_scenario`` or ``scenario_from_dict``) with ``model``, on the
    model's device; returns the Evaluator holding the predictions, ground
    truth and times.  ``parallel`` > 1 selects a batched mode."""
    logger = logger or create_logger("evaluation")
    if next(model.parameters()).is_cuda:
        ops.build_all()
    evaluator = Evaluator()
    label_type = model.label_type
    if scene_cfg.sequential and parallel > 1:
        _run_parallel_sequences(scene_cfg, model, num_points, evaluator, label_type, logger, parallel,
                                upload_dtype)
        return evaluator
    helper = ModelInferenceHelper(model, is_sequential=scene_cfg.sequential, num_points=num_points,
                                  upload_dtype=upload_dtype)
    if parallel > 1:
        _run_batched_pairwise(scene_cfg, helper, evaluator, label_type, logger, parallel)
    else:
        _run_streams(scene_cfg, helper, evaluator, label_type, logger)
    return evaluator


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Model inference for evaluation scenario.")
    parser.add_argument("scenario", type=str, help="scenario configuration (*.yaml)")
    parser.add_argument("model_name", type=str, help="model name (subdirectory of MODEL_PATH)")
    parser.add_argument("output_base", type=str, help="base directory for inference output")
    parser.add_argument("--model_path", type=str, default=None,
                        help="alternative model path instead of MODEL_PATH")
    parser.add_argument("--weights", type=str, default="weights.pt",
                        help="model weights, a state dict (default: weights.pt)")
    parser.add_argument("--num_points", type=int, default=DEFAULT_NUM_POINTS,
                        help="fixed padded cloud size")
    parser.add_argument("--upload_dtype", type=str, default="float32", choices=UPLOAD_DTYPES,
                        help="host->device cloud upload format; uint16 fixed-point halves the transfer "
                             "(~3 mm resolution over +/-100 m)")
    parser.add_argument("--parallel_sequences", type=int, default=1,
                        help="lanes a call: sequential scenarios advance N sequences lock-step, "
                             "pairwise scenarios predict N pairs a call")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import yaml

    from .config import load_model_config

    logger = create_logger("evaluation")
    logger.info("Loading scenario")
    scene_cfg = load_scenario(args.scenario, with_method=False)

    model_base_path = args.model_path or os.getenv("MODEL_PATH")
    if model_base_path is None:
        raise RuntimeError("Could not get model path from environment variable MODEL_PATH or argument.")
    model_path = osp.join(model_base_path, args.model_name)
    model_file = osp.join(model_path, "model_config.yaml")
    weights_file = osp.join(model_path, args.weights)

    logger.info("Read model configuration")
    model_cfg = load_model_config(model_file, weights_file)
    logger.info("Load model")
    model = load_trained_model(model_cfg, weights_file, device=args.device)

    output_stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    output_dir = osp.join(args.output_base, f"{output_stamp}_{scene_cfg.name}_{model_cfg.model_type.name}")
    logger.info("Create output directory")
    os.makedirs(output_dir, exist_ok=True)
    eval_cfg = scene_cfg.to_dict()
    eval_cfg["method"] = {
        "name": model_cfg.model_type.name,
        "params": {"model_name": args.model_name, "model_file": model_file, "weights_file": weights_file},
    }
    with open(osp.join(output_dir, "scenario.yaml"), "w") as f:
        yaml.dump(eval_cfg, f, default_flow_style=False, sort_keys=False)

    evaluator = run_scenario(scene_cfg, model, args.num_points, args.upload_dtype, args.parallel_sequences,
                             logger)
    logger.info("Store results")
    evaluator.write(output_dir)


if __name__ == "__main__":
    main()
