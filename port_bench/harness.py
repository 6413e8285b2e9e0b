"""One run of one cell: set-up, the measured window (or, traced, the
window with the benchmark's spans, then two profiled stretches: the device
alone, then with the host's operations), what the check takes from the
program after the window, the output check, and the result line.  ``run.py`` is the command; tests call
``run_cell`` directly on the CPU."""
from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, Optional, Sequence

import torch

from . import trace as tracing
from .base import Spans, synchronize
from .spec import Spec
from .yardstick.flops import PEAK_BF16_FLOPS, model_flops_per_pair

FORBIDDEN = ("jax", "jaxlib", "flax", "deepclr_tpu")


@dataclass
class Cell:
    workload: Dict
    config: Dict
    traffic: Dict
    seed: int
    device: torch.device
    clouds: Optional[ModuleType] = None   # the traffic's source of clouds, ``clouds/<name>.py``


@dataclass
class Readings:
    """What a per-layer metric's reader may read: the traced run's window
    (``window``: its counts and seconds), the benchmark's spans around calls
    into the program in that window, the profiled stretch's trace, and the
    cell."""
    cell: Cell
    window: Dict[str, float]
    spans: Spans
    trace: tracing.Trace
    stretch_inputs: Optional[list]

    def flops_per_pair(self) -> float:
        return model_flops_per_pair(self.cell.config["model"], int(self.cell.config["num_points"]))

    def ball_pairs(self):
        """(clouds, points, in-radius pairs a scale) of each micro-step of
        the profiled stretch, counted once per distinct batch."""
        from .yardstick import roofline

        seen, out = {}, []
        for batch in self.stretch_inputs:
            if id(batch) not in seen:
                stacked = roofline.stacked_clouds(batch, self.cell.device)
                seen[id(batch)] = (stacked["xyz"].shape[0], stacked["xyz"].shape[1],
                                   roofline.ball_pairs(self.cell.config["model"], stacked["xyz"], stacked["mask"]))
            out.append(seen[id(batch)])
        return out

    def mfu_percent(self, flops_per_pair_done: float) -> float:
        """Algorithmic FLOP/s of the window's completed pairs over the bf16 peak."""
        return 100.0 * self.window["pairs"] * flops_per_pair_done / self.window["seconds"] / PEAK_BF16_FLOPS


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def device_info(device: torch.device, chips: int) -> Dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}


def run_cell(spec: Spec, workload: str, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, extras: Sequence[str] = ()) -> Dict:
    """The result line's object, plus three keys the line leaves out:
    ``readings`` (the compared numbers of the program and of any
    ``extras``), ``setup_split`` (seconds of the set-up's parts) and
    ``marks`` (units done about every second of the window)."""
    w = spec.workload(workload)
    tr = spec.traffic(w["traffic"])
    cell = Cell(w, spec.config(w["config"]), tr, int(seed), device, spec.clouds(tr["clouds"]))
    limits = spec.limits(workload)
    entry = spec.entry(tr["entry"])(cell)
    if trace:
        entry.spans = Spans()
    t_entry = time.perf_counter()
    entry.setup()
    setup_s = time.perf_counter() - t_start
    entry.split["before_s"] = t_entry - t_start
    # what set-up made stays alive all run: out of the collector's way
    gc.collect()
    gc.freeze()
    window = entry.run(seconds)
    gc.unfreeze()
    metrics: Dict[str, Dict] = {}
    breakdown = None
    if trace:
        # the device alone first (the host's operations recorded slow the
        # host-bound stretch), then the same stretch again with them, to
        # name the idle gaps
        units = int(tr["trace_units"])
        profiled = tracing.profile(lambda: entry.stretch(units), lambda: synchronize(device), host=False)
        inputs = entry.stretch_inputs(units) if hasattr(entry, "stretch_inputs") else None
        hosted = tracing.profile(lambda: entry.stretch(units), lambda: synchronize(device), host=True)
    dev = device_info(device, int(w["chips"]))
    entry.finish()
    entry.release()
    if trace:
        readings = Readings(cell, window, entry.spans, profiled, inputs)
        for m in spec.per_layer(workload):
            value = spec.reader(m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = profiled.busy_s
        dev["window_s"] = profiled.window_s
        breakdown = {"device_ops": profiled.breakdown()["device_ops"], "idle_gaps": hosted.breakdown()["idle_gaps"]}
    else:
        for m in spec.end_to_end(workload):
            value = setup_s if m["name"] == "setup_s" else window[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    compared = entry.check(extras)
    numbers = compared["program"]
    checked = {name: {"value": numbers.get(name, math.inf), "limit": float(limit)} for name, limit in limits.items()}
    correct = entry.failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checked.values())
    result = {"correct": bool(correct), "attempted": int(entry.attempted), "failed": int(entry.failed),
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = checked
    result["readings"] = compared
    result["setup_split"] = entry.split
    result["marks"] = entry.marks
    return result
