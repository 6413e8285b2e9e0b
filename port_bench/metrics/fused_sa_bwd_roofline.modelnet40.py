"""Share of its roofline of the fused set abstraction's backward
(``csrc/fused_sa.cu`` via ``ops/fused_sa.py``): the least time of the
stretch's work, counted from each batch's in-radius pairs under the
reference's centres and the configuration's widths
(``yardstick/roofline.py::fused_sa_bwd_least``), over the device time of
the kernels named here."""

NAME = "fused_sa_bwd_roofline.modelnet40"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "train_pairs_per_s"
WORKLOADS = ['modelnet40.train']

KERNELS = ["da_scale_kernel", "fused_sa_bwd_kernel", "fused_sa_bwd_finish_kernel"]


def read(r):
    from port_bench.yardstick import roofline

    spent = r.trace.kernel_seconds(KERNELS)
    if not spent or not r.stretch_inputs:
        return None
    least = sum(roofline.fused_sa_bwd_least(r.cell.config["model"], clouds, points, pairs)
                for clouds, points, pairs in r.ball_pairs())
    return 100.0 * least / spent
