"""Where the time of one flagship forward goes, on the card.

    python -m deepclr_tpu_torch.profile_forward

Builds the flagship KITTI model (bf16, random weights from seed 0), makes
16 pairs of 16384-point KITTI-like clouds from a seed, warms up, then traces
5 forwards with ``torch.profiler`` and prints one JSON line per quantity:
the card and its power limit, the host time per forward, the device time
per forward summed over kernels, the device idle share, and the kernels
with the most device time.  Requires a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .configs import KITTI_MODEL_CFG
from .models import build_model

PAIRS, POINTS = 16, 16384   # the flagship serving workload
ITERS, TOP = 5, 20          # traced forwards, kernel rows printed


def _clouds(batch: int, n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(batch, n, 3)).astype(np.float32) * np.array([30.0, 30.0, 2.0], np.float32)
    extra = rng.uniform(0.0, 1.0, size=(batch, n, 1)).astype(np.float32)
    return torch.from_numpy(np.concatenate([pts, extra], axis=-1))


def _is_kernel(e) -> bool:
    """A device row that is a kernel or a copy, not an operator's GPU
    annotation (those repeat the device time of the kernels under them)."""
    return (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False) and not e.key.startswith("aten::"))


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    with torch.inference_mode():
        model = build_model(KITTI_MODEL_CFG, device=dev, seed=0)
        t = _clouds(PAIRS, POINTS, 1).to(dev)
        s = _clouds(PAIRS, POINTS, 2).to(dev)
        mask = torch.ones(PAIRS, POINTS, dtype=torch.bool, device=dev)
        for _ in range(3):
            model(t, s, mask, mask)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ITERS):
                model(t, s, mask, mask)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / ITERS

    rows = [e for e in prof.key_averages() if _is_kernel(e)]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3 / ITERS
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(json.dumps({"card": card, "pairs": PAIRS, "points": POINTS, "iters": ITERS}))
    print(json.dumps({"host_ms_per_forward_traced": host_ms, "device_ms_per_forward": device_ms,
                      "device_idle_share": max(0.0, 1.0 - device_ms / host_ms),
                      "kernel_launches_per_forward": sum(e.count for e in rows) / ITERS}))
    for e in rows[:TOP]:
        print(json.dumps({"kernel": e.key[:90], "device_ms_per_forward": e.self_device_time_total / 1e3 / ITERS,
                          "calls_per_forward": e.count / ITERS}))


if __name__ == "__main__":
    main()
