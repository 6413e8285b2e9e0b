"""Reading a ``torch.profiler`` trace of a stretch of work: the device
operations, their union (busy time), the idle gaps and what the host was
doing in them.

``is_device_op`` is a frozen copy of ``deepclr_tpu_torch/profile_forward.py
::_is_kernel``: a device row that is a kernel or a copy, not an operator's
GPU annotation (those repeat the device time of the kernels under them).
"""
from __future__ import annotations

import heapq
import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

STRETCH = "port_bench.stretch"
TOP = 10


def is_device_op(e) -> bool:
    from torch.autograd import DeviceType

    return (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False) and not e.key.startswith("aten::"))


def union_seconds(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals, clipped to [lo, hi)."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def idle_gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    gaps, at = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def host_ops_at(host: Sequence[Tuple[float, float, str]], times: Sequence[float]) -> List[str]:
    """For each time, the innermost host operation running then (the latest
    start among those that cover it)."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    events = sorted(host)
    names = ["host, no operation"] * len(times)
    live: List[Tuple[float, float, str]] = []
    at = 0
    for i in order:
        t = times[i]
        while at < len(events) and events[at][0] <= t:
            s, e, name = events[at]
            heapq.heappush(live, (-s, e, name))
            at += 1
        # an operation that has ended is over for every later time too
        while live and live[0][1] <= t:
            heapq.heappop(live)
        if live:
            names[i] = live[0][2]
    return names


@dataclass
class Trace:
    """Device operations (name, start s, end s), host operations, and the
    traced stretch [lo, hi), all on the profiler's clock in seconds."""
    device: List[Tuple[str, float, float]]
    host: List[Tuple[float, float, str]]
    lo: float
    hi: float
    count: int = 0                      # units of work in the stretch

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.device], self.lo, self.hi)

    def kernel_seconds(self, names: Sequence[str]) -> float:
        """Device seconds of the operations whose name holds one of ``names``
        as a whole identifier (a demangled name: ``void k<true>(...)``)."""
        pattern = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(map(re.escape, names)) + r")(?![A-Za-z0-9_])")
        return sum(e - s for n, s, e in self.device if pattern.search(n))

    def breakdown(self) -> Dict[str, List[List[object]]]:
        ops: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            ops[n[:120]] += e - s
        gaps: Dict[str, float] = defaultdict(float)
        holes = idle_gaps([(s, e) for _, s, e in self.device], self.lo, self.hi)
        for (s, e), name in zip(holes, host_ops_at(self.host, [(s + e) / 2 for s, e in holes])):
            gaps[name[:120]] += e - s
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def from_events(events) -> Trace:
    """A ``Trace`` from a profiler's ``events()``; the stretch is the
    ``STRETCH`` annotation's host span, or, where the host was not
    recorded, from the first device operation's start to the last one's
    end (the stretch starts and ends on a drained queue)."""
    from torch.autograd import DeviceType

    device, host, span = [], [], None
    for e in events:
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.name == STRETCH and e.device_type == DeviceType.CPU:
            span = (s, t)
        elif is_device_op(e):
            device.append((e.name, s, t))
        elif e.device_type == DeviceType.CPU and e.name != STRETCH:
            host.append((s, t, e.name))
    if not device:
        raise RuntimeError("trace: the profiler recorded no device operation")
    if span is None:
        span = (min(s for _, s, _ in device), max(e for _, _, e in device))
    return Trace(device, host, span[0], span[1])


def profile(stretch: Callable[[], int], synchronize: Callable[[], None], host: bool = True) -> Trace:
    """Run ``stretch`` (which returns its count of work) under the
    profiler, device queue drained on both ends; ``host`` records the
    host's operations too."""
    from torch.profiler import ProfilerActivity, profile as _profile, record_function

    synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with _profile(activities=activities) as prof:
        with record_function(STRETCH):
            count = stretch()
            synchronize()
    trace = from_events(prof.events())
    trace.count = count
    return trace
