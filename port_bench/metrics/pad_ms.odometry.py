"""Host ms a frame spent in ``models.base.pad_cloud`` (the helper's
subsample of a raw scan), timed by the benchmark's wrapper around the
module-level function over the traced run's window."""

NAME = "pad_ms.odometry"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "inference helper"
MOVES = "frame_ms_p95"
WORKLOADS = ['kitti.odometry']


def read(r):
    frames = r.window.get("frames")
    if not frames or "pad_cloud" not in r.spans.seconds:
        return None
    return 1e3 * r.spans.seconds["pad_cloud"] / frames
