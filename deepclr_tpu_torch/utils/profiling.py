"""Profiling helpers (the JAX package's ``utils/profiling.py``):

* ``sync``: wait for the CUDA devices of some tensors;
* ``device_timer``: host-clock time of a block that ends in ``sync``;
* ``trace``: a ``torch.profiler`` trace of a block, written as a Chrome
  trace file (``chrome://tracing``, Perfetto).
"""
from __future__ import annotations

import contextlib
import os
import os.path as osp
import time
from typing import Any, Iterator, Optional

import torch

__all__ = ["device_timer", "sync", "trace"]


def _tensors(x: Any) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def sync(x: Any) -> None:
    """``torch.cuda.synchronize`` on the device of every CUDA tensor in
    ``x`` (a tensor or nested dicts / lists / tuples of them); nothing to
    wait for on the CPU."""
    for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def device_timer(label: str = "", result_holder: Optional[dict] = None) -> Iterator[dict]:
    """Time a block; the block ends with ``sync`` of its outputs so their
    device work is inside the time.

    Usage:
        with device_timer("step") as t:
            out = step(...)
            sync(out)
        print(t["ms"])
    """
    holder = result_holder if result_holder is not None else {}
    t0 = time.perf_counter()
    yield holder
    holder["ms"] = (time.perf_counter() - t0) * 1000.0
    if label:
        print(f"{label}: {holder['ms']:.2f} ms")


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile a block with ``torch.profiler`` (the CPU, and CUDA when a
    card is present) and write ``logdir/trace.json``.  Yields the profiler,
    whose ``key_averages()`` hold the sums by operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(osp.join(logdir, "trace.json"))
