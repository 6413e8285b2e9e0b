"""Where the time of the flagship train micro-step goes, on the card.

    python -m deepclr_tpu_torch.profile_train

Builds the flagship KITTI model (bf16, random weights from seed 0) with its
training recipe (``KITTI_TRAIN_CFG``: Ranger, trans + 200 rot, accumulation
2) and the trainer's own step (``engine.make_train_step``), makes 5 pairs of
16384-point KITTI-like clouds whose sources are small rigid motions of the
templates, warms up, then runs 4 micro-steps (2 optimizer updates) three
times:

1. untraced, with one synchronise at the end: host time per micro-step;
2. traced with ``torch.profiler``, again with one synchronise at the end:
   the device time per micro-step summed over kernels and copies, and the
   kernels with the most device time;
3. untraced, with the step's spans on (``utils.profiling``) and, as in
   run 1, one synchronise at the end: host ms a micro-step of each child of
   ``train.step`` (``train.upload``, ``forward``, ``backward``, ``update``,
   ``metrics``).  Nothing synchronises between them, so each is its host
   time: dispatch, or a wait where the host blocks on the device (a
   pageable upload behind the previous micro-step's kernels).

Prints one JSON line per quantity: the card and its power limit, the host
times of runs 1, 2 and 3, the device time, the device idle share against
each, the split, and the kernel rows.  Requires a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from . import solver
from .configs import KITTI_MODEL_CFG, KITTI_TRAIN_CFG
from .engine import create_train_state, make_train_step
from .losses import make_loss_fn, make_metric_fns
from .models import build_model
from .profile_forward import _is_kernel
from .synthetic import train_batch
from .utils.profiling import enable_spans, reset_spans, span_stats

PAIRS, POINTS = 5, 16384    # the flagship training batch
ITERS, TOP = 4, 25          # micro-steps per run (2 updates), kernel rows printed
LR = 1e-6


def _span_split(run):
    """``run()``'s host ms a micro-step with the spans on, and the host ms
    a micro-step of each span it recorded."""
    reset_spans()
    previous = enable_spans(True)
    try:
        ms = run()
    finally:
        enable_spans(previous)
    return ms, {name: s["seconds"] * 1e3 / ITERS for name, s in span_stats().items()}


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    model = build_model(KITTI_MODEL_CFG, device=dev, seed=0)
    metrics = KITTI_TRAIN_CFG["metrics"]
    opt = solver.make_optimizer(KITTI_TRAIN_CFG, model.parameters())
    k = KITTI_TRAIN_CFG["optimizer"]["accumulation_steps"]
    step = make_train_step(model, opt, make_loss_fn(metrics["loss"], KITTI_MODEL_CFG["label_type"]),
                           make_metric_fns(metrics["loss"], metrics["other"], KITTI_MODEL_CFG["label_type"]),
                           accumulation_steps=k)
    state = create_train_state(model)
    batch = {key: torch.from_numpy(v).to(dev) for key, v in train_batch(PAIRS, POINTS, seed=3).items()}

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
    spans_ms, split = _span_split(run)

    rows = [e for e in prof.key_averages() if _is_kernel(e)]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3 / ITERS
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(json.dumps({"card": card, "pairs": PAIRS, "points": POINTS, "micro_steps": ITERS,
                      "accumulation_steps": k}))
    print(json.dumps({"host_ms_per_micro_step": host_ms, "host_ms_per_micro_step_traced": traced_ms,
                      "device_ms_per_micro_step": device_ms,
                      "device_idle_share": max(0.0, 1.0 - device_ms / host_ms),
                      "device_idle_share_traced": max(0.0, 1.0 - device_ms / traced_ms),
                      "kernel_launches_per_micro_step": sum(e.count for e in rows) / ITERS}))
    print(json.dumps({"host_ms_per_micro_step_spans_on": spans_ms, "span_ms_per_micro_step": split,
                      "update_ms_per_update": split.get("train.update", 0.0) * k}))
    for e in rows[:TOP]:
        print(json.dumps({"kernel": e.key[:90], "device_ms_per_micro_step": e.self_device_time_total / 1e3 / ITERS,
                          "calls_per_micro_step": e.count / ITERS}))


if __name__ == "__main__":
    main()
