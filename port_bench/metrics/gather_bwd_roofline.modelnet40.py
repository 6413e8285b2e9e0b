"""Share of its roofline of the gather backward (``csrc/gather.cu`` via
``ops/grouping.py``: the run index, then the sum): the least time of the
stretch's gather backwards, counted from the configuration's widths and
each micro-step's pairs (``yardstick/gather.py::gather_bwd_least``), over
the device time of the kernels named here."""

NAME = "gather_bwd_roofline.modelnet40"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "train_pairs_per_s"
WORKLOADS = ['modelnet40.train']

KERNELS = ["gather_bwd_index_kernel", "gather_bwd_sum_kernel"]


def read(r):
    from port_bench.yardstick.gather import gather_bwd_least

    spent = r.trace.kernel_seconds(KERNELS)
    if not spent or not r.stretch_inputs:
        return None
    least = sum(gather_bwd_least(r.cell.config["model"], b["template"].shape[0]) for b in r.stretch_inputs)
    return 100.0 * least / spent
