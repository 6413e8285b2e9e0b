"""The device's idle share of the window: 1 - (device seconds a unit) /
(window seconds a unit).  The device seconds are the union of the
intervals of the kernels, copies and sets of the profiled stretch (the
profiler recording the device alone) over its units; the window's seconds
a unit are the traced run's window's own (the profiler off).  The stretch's own length is not the
denominator: the profiler's work at every launch slows the host-bound
stretch by about half."""

NAME = "idle_share.modelnet40"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "train_pairs_per_s"
WORKLOADS = ['modelnet40.train']


def read(r):
    if not r.trace.count or not r.window.get("units"):
        return None
    return 100.0 * (1.0 - (r.trace.busy_s / r.trace.count) / (r.window["seconds"] / r.window["units"]))
