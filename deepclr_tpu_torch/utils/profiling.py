"""Profiling helpers (the JAX package's ``utils/profiling.py``):

* ``sync``: wait for the CUDA devices of some tensors;
* ``device_timer``: host-clock time of a block that ends in ``sync``;
* ``trace``: a ``torch.profiler`` trace of a block, written as a Chrome
  trace file (``chrome://tracing``, Perfetto), with the spans on;
* ``span``: the port's own spans at its layer boundaries (the inference
  helper, the train step, the model's blocks, the loader), off until
  ``enable_spans(True)``;
* ``count``: counters kept on the device beside the spans, on and off
  with them.

Spans.  Off (the default), ``span`` checks one flag and returns a shared
no-op context: no clock read, no ``record_function``, no allocation.  On,
a span reads ``time.perf_counter_ns`` on entry and exit and, while a
``torch.profiler`` records, enters ``record_function(name)``: it then lies
on the device trace's clock.  Each thread keeps its own stack of open
spans: a span's parent is the innermost open span of its own thread, and a
span given no ``id`` takes its parent's (the spans of one frame or
micro-step share one).  On exit a span adds to its name's ``count``,
``seconds`` and ``self_seconds`` (its duration less the part its child spans
cover; ``span_stats``) and appends ``(name, id, parent name, start_ns,
end_ns)`` to a buffer of the last ``SPAN_BUFFER`` spans (``spans``).  No
span synchronises a device: a span around asynchronous device work times
its dispatch, and the span that waits for its result holds the wait.

Counters.  ``count(name, mask, total)`` adds the true elements of a mask
to the counter ``name`` (and its element count to ``total``) while spans
are on; off, it checks the one flag and returns.  The sum stays on the
mask's device, one launch and no synchronise, and nothing is counted
while the current CUDA stream captures a graph: a replay runs no Python,
so a count captured into it would add on every replay unseen.
``counter_stats`` reads every counter with one synchronise;
``reset_spans`` clears them with the spans.
"""
from __future__ import annotations

import contextlib
import os
import os.path as osp
import threading
import time
from collections import deque
from typing import Any, Dict, Hashable, Iterator, List, Optional, Tuple

import torch
from torch.profiler import record_function

__all__ = ["SPAN_BUFFER", "count", "counter_stats", "device_timer", "enable_spans", "reset_spans", "span",
           "span_stats", "spans", "sync", "trace"]

SPAN_BUFFER = 200_000   # spans kept by ``spans()``; the oldest are dropped

_spans_on = False
_OFF = contextlib.nullcontext()
_now = time.perf_counter_ns
_profiler_enabled = torch.autograd._profiler_enabled
_local = threading.local()                  # .stack: this thread's open spans
_lock = threading.Lock()                    # guards _totals and _counters
_totals: Dict[str, List[int]] = {}          # name -> [count, ns, self ns]
_counters: Dict[str, Any] = {}              # name -> a host int, or an int64 tensor on a device
_records: deque = deque(maxlen=SPAN_BUFFER)


class _Span:
    __slots__ = ("name", "id", "parent", "start", "child_ns", "scope", "kept")

    def __init__(self, name: str, id: Optional[Hashable]):
        self.name, self.id = name, id

    def __enter__(self) -> "_Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        if self.id is None and self.parent is not None:
            self.id = self.parent.id
        self.child_ns, self.kept = 0, True
        stack.append(self)
        self.scope = record_function(self.name) if _profiler_enabled() else None
        if self.scope is not None:
            self.scope.__enter__()
        self.start = _now()
        return self

    def discard(self) -> None:
        """Record nothing of this span when it exits (its ``record_function``
        scope stays in a trace)."""
        self.kept = False

    def __exit__(self, *exc) -> None:
        end = _now()
        if self.scope is not None:
            self.scope.__exit__(*exc)
        _local.stack.pop()
        if not self.kept:
            return
        ns = end - self.start
        parent = self.parent
        if parent is not None:
            parent.child_ns += ns
        with _lock:
            total = _totals.get(self.name)
            if total is None:
                total = _totals[self.name] = [0, 0, 0]
            total[0] += 1
            total[1] += ns
            total[2] += ns - self.child_ns
        _records.append((self.name, self.id, None if parent is None else parent.name, self.start, end))


def span(name: str, id: Optional[Hashable] = None):
    """A context manager timing its block as the span ``name`` while spans
    are on (``enable_spans``); a shared no-op context while they are off.
    On, ``with span(...) as s`` binds the span, whose ``discard()`` leaves
    it unrecorded; off, it binds None."""
    if not _spans_on:
        return _OFF
    return _Span(name, id)


def enable_spans(on: bool) -> bool:
    """Turn spans on or off for every thread; returns the previous state."""
    global _spans_on
    previous, _spans_on = _spans_on, bool(on)
    return previous


def reset_spans() -> None:
    """Forget every recorded span and counter: the sums, the buffer and the counts."""
    with _lock:
        _totals.clear()
        _records.clear()
        _counters.clear()


def count(name: str, mask: torch.Tensor, total: Optional[str] = None) -> None:
    """While spans are on and the current CUDA stream is not capturing a
    graph: add ``mask``'s true elements to the counter ``name`` (a sum on
    the mask's device, no synchronise) and, given ``total``, its element
    count to the counter ``total``.  Off, one flag check."""
    if not _spans_on:
        return
    if mask.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    n = mask.sum(dtype=torch.int64)
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
        if total is not None:
            _counters[total] = _counters.get(total, 0) + mask.numel()


def counter_stats() -> Dict[str, int]:
    """``{name: count}`` of the counters since the last ``reset_spans``,
    read with one synchronise."""
    with _lock:
        out = dict(_counters)
    on_device = [name for name, v in out.items() if torch.is_tensor(v)]
    if on_device:
        home = out[on_device[0]].device
        out.update(zip(on_device, torch.stack([out[name].to(home) for name in on_device]).tolist()))
    return out


def span_stats() -> Dict[str, Dict[str, float]]:
    """``{name: {"count", "seconds", "self_seconds"}}`` of the spans that
    have exited since the last ``reset_spans``."""
    with _lock:
        return {name: {"count": c, "seconds": ns / 1e9, "self_seconds": self_ns / 1e9}
                for name, (c, ns, self_ns) in _totals.items()}


def spans() -> List[Tuple[str, Optional[Hashable], Optional[str], int, int]]:
    """The last ``SPAN_BUFFER`` spans, in the order they exited:
    ``(name, id, parent name, start_ns, end_ns)`` on ``time.perf_counter_ns``."""
    return list(_records)


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
    card is present) and write ``logdir/trace.json``.  Spans are on inside
    the block, so the trace names them; their previous state returns after
    it.  Yields the profiler, whose ``key_averages()`` hold the sums by
    operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    previous = enable_spans(True)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    finally:
        enable_spans(previous)
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(osp.join(logdir, "trace.json"))
