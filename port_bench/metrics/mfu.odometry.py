"""The whole step's share of the card's bf16 peak: the algorithmic FLOPs of
the work the traced run's window completed (a registered frame, counted
1x the pair forward; ``yardstick/flops.py``) over its host-clock
seconds, outside the profiled stretch."""

NAME = "mfu.odometry"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "whole step"
MOVES = "frame_ms_p95"
WORKLOADS = ['kitti.odometry']

FORWARDS = 1


def read(r):
    if not r.window.get("pairs"):
        return None
    return r.mfu_percent(FORWARDS * r.flops_per_pair())
