"""Device operations (kernels, copies, sets) a micro-step, counted in the
profiled stretch."""

NAME = "launches.train"
UNIT = "launches"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "trainer and model"
MOVES = "train_pairs_per_s"
WORKLOADS = ['kitti.train']


def read(r):
    if not r.trace.count:
        return None
    return len(r.trace.device) / r.trace.count
