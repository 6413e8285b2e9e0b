"""The whole step's share of the card's bf16 peak: the algorithmic FLOPs of
the work the traced run's window completed (a training pair, forward and
backward, counted 3x the forward; ``yardstick/flops.py``) over its host-
clock seconds, outside the profiled stretch."""

NAME = "mfu.modelnet40"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "whole step"
MOVES = "train_pairs_per_s"
WORKLOADS = ['modelnet40.train']

FORWARDS = 3


def read(r):
    if not r.window.get("pairs"):
        return None
    return r.mfu_percent(FORWARDS * r.flops_per_pair())
