"""``ModelInferenceHelper(is_sequential=True).predict``, one raw frame a
call and its pose fetched to the host, one stream in a closed loop.  Frames
play back and forth along the drive, so every pair is two neighbouring
frames and the stream never restarts.  A frame is one unit; the window's
metric is ``frame_ms_p95``, the 95th percentile of every frame's host
time."""
from __future__ import annotations

import time
from typing import Dict

import numpy as np

from port_bench import check
from port_bench.base import HelperEntry, Spans, synchronize


class SequentialEntry(HelperEntry):
    def setup(self) -> None:
        self.setup_helper(is_sequential=True)
        n = len(self.frames)
        self.order = list(range(n)) + list(range(n - 2, 0, -1))
        self.pos = 0
        t0 = time.perf_counter()
        first = self._frame()
        if self.helper.predict(first) is not None:
            raise RuntimeError("sequential: the first frame returned a pose")
        for _ in range(int(self.cell.traffic["warmup_frames"])):
            self.helper.predict(self._frame())
        synchronize(self.device)
        self.split["warmup_s"] = time.perf_counter() - t0

    def _frame(self) -> np.ndarray:
        f = self.order[self.pos % len(self.order)]
        self.pos += 1
        self.draws.append(f)
        return self.frames[f]

    def run(self, seconds: float) -> Dict[str, float]:
        original = self._instrument(self.spans)
        latencies = []
        try:
            t_start = time.perf_counter()
            while True:
                frame = self._frame()
                t0 = time.perf_counter()
                pose = self.helper.predict(frame)
                t1 = time.perf_counter()
                latencies.append(t1 - t0)
                if t1 - t_start >= len(self.marks) + 1:
                    self.marks.append((t1 - t_start, len(latencies)))
                self.outputs.append(((len(self.draws) - 2, len(self.draws) - 1), pose))
                if t1 - t_start >= seconds:
                    break
            elapsed = time.perf_counter() - t_start
        finally:
            self._restore(original)
        self.attempted = len(latencies)
        self.failed = self.failures(self.outputs)
        return {"seconds": elapsed, "units": len(latencies), "frames": len(latencies), "pairs": len(latencies),
                "frame_ms_p95": float(np.percentile(np.asarray(latencies) * 1e3, 95))}

    def stretch(self, units: int) -> int:
        original = self._instrument(Spans() if self.spans is not None else None)
        try:
            for _ in range(units):
                self.helper.predict(self._frame())
        finally:
            self._restore(original)
        return units

    def check(self, extras=()) -> Dict[str, Dict[str, float]]:
        return check.pose_numbers(self, self.outputs, extras)


ENTRY = SequentialEntry
