"""Where the time of a train micro-step goes, on the card.

    python -m deepclr_tpu_torch.profile_train [--recipe kitti|modelnet40]

Builds the recipe's model (bf16, random weights from seed 0) with its
training recipe and the trainer's own step (``engine.make_train_step``):
``kitti`` (the default) the flagship (``KITTI_TRAIN_CFG``: Ranger, trans +
200 rot, accumulation 2) at the recipe's 5 pairs a micro-step of
16384-point KITTI-like clouds whose sources are small rigid motions of the
templates; ``modelnet40`` (``MODELNET40_TRAIN_CFG``: trans + rot) at the
benchmark cell's 128 pairs a micro-step of 2048-point CAD-like self-pairs
moved by the recipe's motion (``synthetic.cad_train_batch``).  Warms up,
then runs 4 micro-steps (2 optimizer updates) three times:

1. untraced, with one synchronise at the end: host time per micro-step;
2. traced with ``torch.profiler``, again with one synchronise at the end:
   the device time per micro-step summed over kernels and copies, and the
   kernels with the most device time;
3. untraced, with the step's spans on (``utils.profiling``) and, as in
   run 1, one synchronise at the end: host ms a micro-step of each child of
   ``train.step`` (``train.upload``, ``forward``, ``backward``, ``update``,
   ``metrics``) and of the model's blocks inside ``train.forward``
   (``model.encode``, ``model.merge``, ``model.head``).  Nothing
   synchronises between them, so each is its host time: dispatch, or a
   wait where the host blocks on the device (a full launch queue: the
   step itself never waits for it).  The counters of the same run give the
   motion embedding's pairs a micro-step and the share of them at or
   beyond its radius (``merge.pairs``, ``merge.cut``).

Prints one JSON line per quantity: the card and its power limit, the host
times of runs 1, 2 and 3, the device time, the device idle share against
each, the split and the counts, and the kernel rows.  Requires a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from . import solver
from .configs import KITTI_MODEL_CFG, KITTI_TRAIN_CFG, MODELNET40_MODEL_CFG, MODELNET40_TRAIN_CFG
from .engine import create_train_state, make_train_step
from .losses import make_loss_fn, make_metric_fns
from .models import build_model
from .profile_forward import _is_kernel
from .synthetic import cad_train_batch, train_batch
from .utils.profiling import counter_stats, enable_spans, reset_spans, span_stats

# recipe -> (model, training recipe, pairs a micro-step, points a cloud, batch maker)
RECIPES = {"kitti": (KITTI_MODEL_CFG, KITTI_TRAIN_CFG, 5, 16384, train_batch),
           "modelnet40": (MODELNET40_MODEL_CFG, MODELNET40_TRAIN_CFG, 128, 2048, cad_train_batch)}
ITERS, TOP = 4, 25          # micro-steps per run (2 updates), kernel rows printed
LR = 1e-6


def _span_split(run):
    """``run()``'s host ms a micro-step with the spans on, the host ms a
    micro-step of each span it recorded, and its counters."""
    reset_spans()
    previous = enable_spans(True)
    try:
        ms = run()
    finally:
        enable_spans(previous)
    return ms, {name: s["seconds"] * 1e3 / ITERS for name, s in span_stats().items()}, counter_stats()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--recipe", choices=sorted(RECIPES), default="kitti")
    args = parser.parse_args(argv)
    model_cfg, train_cfg, pairs, points, make_batch = RECIPES[args.recipe]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    model = build_model(model_cfg, device=dev, seed=0)
    metrics = train_cfg["metrics"]
    opt = solver.make_optimizer(train_cfg, model.parameters())
    k = train_cfg["optimizer"]["accumulation_steps"]
    step = make_train_step(model, opt, make_loss_fn(metrics["loss"], model_cfg["label_type"]),
                           make_metric_fns(metrics["loss"], metrics["other"], model_cfg["label_type"]),
                           accumulation_steps=k)
    state = create_train_state(model)
    batch = {key: torch.from_numpy(v).to(dev) for key, v in make_batch(pairs, points, seed=3).items()}

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            step(state, batch, LR)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / ITERS

    run()  # warm-up: builds the kernels, two updates
    host_ms = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = run()
    spans_ms, split, counts = _span_split(run)

    rows = [e for e in prof.key_averages() if _is_kernel(e)]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3 / ITERS
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(json.dumps({"card": card, "recipe": args.recipe, "pairs": pairs, "points": points,
                      "micro_steps": ITERS, "accumulation_steps": k}))
    print(json.dumps({"host_ms_per_micro_step": host_ms, "host_ms_per_micro_step_traced": traced_ms,
                      "device_ms_per_micro_step": device_ms,
                      "device_idle_share": max(0.0, 1.0 - device_ms / host_ms),
                      "device_idle_share_traced": max(0.0, 1.0 - device_ms / traced_ms),
                      "kernel_launches_per_micro_step": sum(e.count for e in rows) / ITERS}))
    print(json.dumps({"host_ms_per_micro_step_spans_on": spans_ms, "span_ms_per_micro_step": split,
                      "update_ms_per_update": split.get("train.update", 0.0) * k}))
    pairs_seen = counts.get("merge.pairs", 0)
    print(json.dumps({"merge_pairs_per_micro_step": pairs_seen / ITERS,
                      "merge_cut_share": counts.get("merge.cut", 0) / pairs_seen if pairs_seen else None}))
    for e in rows[:TOP]:
        print(json.dumps({"kernel": e.key[:90], "device_ms_per_micro_step": e.self_device_time_total / 1e3 / ITERS,
                          "calls_per_micro_step": e.count / ITERS}))


if __name__ == "__main__":
    main()
