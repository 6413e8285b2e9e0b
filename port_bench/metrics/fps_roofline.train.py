"""Share of its roofline of furthest point sampling (``csrc/fps.cu`` via
``ops/fps.py``): the least time of the stretch's sampling, counted from
the clouds and the configuration's centres
(``yardstick/roofline.py::fps_least``), over the device time of the
kernels named here."""

NAME = "fps_roofline.train"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "train_pairs_per_s"
WORKLOADS = ['kitti.train']

KERNELS = ["fps_kernel"]


def read(r):
    from port_bench.yardstick import roofline

    spent = r.trace.kernel_seconds(KERNELS)
    if not spent or not r.stretch_inputs:
        return None
    least = sum(roofline.fps_least(r.cell.config["model"], 2 * b["template"].shape[0], b["template"].shape[1])
                for b in r.stretch_inputs)
    return 100.0 * least / spent
