"""Window arithmetic: a rate is taken over the whole window, a tail over
all frames, and the idle share over the union of device intervals; a stall
moves each of them."""
from __future__ import annotations

import time
import numpy as np
import pytest
import torch

from port_bench import trace as tracing
from port_bench.entries.sequential import SequentialEntry
from port_bench.entries.train import TrainEntry

STEP_S = 0.002
STALL_S = 0.12


def _train(stall_at=None):
    entry = TrainEntry.__new__(TrainEntry)
    calls = []

    def step(state, batch, lr):
        calls.append(1)
        time.sleep(STALL_S if len(calls) == stall_at else STEP_S)
        return {"loss": torch.tensor(1.0)}

    entry.step, entry.state, entry.lr, entry.k, entry.next = step, None, 1e-3, 2, 0
    entry.batches = [{"template": np.zeros((5, 8, 3))}]
    entry.device, entry.spans, entry.marks = torch.device("cpu"), None, []
    return entry


def test_rate_over_the_whole_window():
    plain = _train().run(0.2)
    stalled = _train(stall_at=5).run(0.2)
    assert plain["micro_steps"] % 2 == 0 and stalled["micro_steps"] % 2 == 0
    assert plain["pairs"] == 5 * plain["micro_steps"]
    assert plain["train_pairs_per_s"] == pytest.approx(plain["pairs"] / plain["seconds"])
    # the stall's time is in the window: fewer pairs in about as long
    assert stalled["train_pairs_per_s"] < 0.8 * plain["train_pairs_per_s"]


class _Helper:
    def __init__(self, stall_every=None):
        self.n, self.stall_every = 0, stall_every

    def predict(self, frame):
        self.n += 1
        time.sleep(STALL_S / 4 if self.stall_every and self.n % self.stall_every == 0 else STEP_S)
        return np.zeros(8)


def _sequential(stall_every=None):
    entry = SequentialEntry.__new__(SequentialEntry)
    entry.helper, entry.frames, entry.order, entry.pos = _Helper(stall_every), [np.zeros((4, 4))] * 3, [0, 1, 2, 1], 0
    entry.draws, entry.outputs, entry.spans, entry.marks = [0], [], None, []
    return entry


def test_tail_over_all_frames():
    plain = _sequential().run(0.3)
    # one frame in ten stalls: inside the slowest 5%, so the 95th percentile moves
    stalled = _sequential(stall_every=10).run(0.3)
    assert plain["frames"] == len(_seq_outputs(plain))
    assert plain["frame_ms_p95"] < 2 * STEP_S * 1e3 + 5
    assert stalled["frame_ms_p95"] > STALL_S / 4 * 1e3 * 0.9


def _seq_outputs(window):
    return range(window["frames"])


def test_idle_share_is_the_union_of_intervals():
    ops = [("a", 0.0, 0.4), ("b", 0.2, 0.6), ("c", 0.7, 1.0)]   # overlapping a and b count once
    trace = tracing.Trace(ops, [(0.0, 2.0, "step"), (0.6, 0.7, "aten::copy_")], 0.0, 1.0, count=1)
    assert trace.busy_s == pytest.approx(0.9)
    stalled = tracing.Trace([("a", 0.0, 0.4), ("b", 0.2, 0.6), ("c", 1.2, 1.5)],
                            [(0.0, 2.0, "step"), (0.6, 1.2, "cudaStreamSynchronize")], 0.0, 1.5, count=1)
    assert 1 - stalled.busy_s / stalled.window_s > 1 - trace.busy_s / trace.window_s
    gaps = dict((k, v) for k, v in stalled.breakdown()["idle_gaps"])
    assert gaps == {"cudaStreamSynchronize": pytest.approx(0.6)}
    assert dict(trace.breakdown()["device_ops"])["b"] == pytest.approx(0.4)


def test_kernel_names_match_whole_identifiers():
    ops = [("void (anonymous namespace)::fused_sa_bwd_kernel<32, 32, 64, true>(float4 const*)", 0, 1),
           ("void (anonymous namespace)::fused_sa_kernel<32, 32, 64, true, false>(float4 const*)", 1, 3),
           ("void (anonymous namespace)::fused_sa_bwd_finish_kernel(float const*, int)", 3, 7)]
    trace = tracing.Trace(ops, [], 0, 7)
    assert trace.kernel_seconds(["fused_sa_bwd_kernel"]) == 1
    assert trace.kernel_seconds(["fused_sa_kernel"]) == 2
    assert trace.kernel_seconds(["fused_sa_bwd_kernel", "fused_sa_bwd_finish_kernel"]) == 5
