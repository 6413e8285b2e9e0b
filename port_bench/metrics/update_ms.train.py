"""Host ms of one ``optimizer.step`` (Ranger) with no synchronise, its
dispatch cost, between the optimizer's step hooks over the traced run's
window."""

NAME = "update_ms.train"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "optimizer"
MOVES = "train_pairs_per_s"
WORKLOADS = ['kitti.train']


def read(r):
    n = r.spans.counts.get("optimizer.step", 0)
    if not n:
        return None
    return 1e3 * r.spans.seconds["optimizer.step"] / n
