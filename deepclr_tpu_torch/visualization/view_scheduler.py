"""Plot the learning-rate schedule of a training configuration
(scripts/visualization/view_scheduler.py):

    python -m deepclr_tpu_torch.visualization.view_scheduler CONFIG [--output FILE]

samples the schedule at 2000 iterations evenly spaced over
[0, optimizer.max_iterations] (100000 when unset) and writes it, on a log
scale, to FILE (default lr_schedule.png; matplotlib, Agg backend).
``schedule_samples`` computes the samples without matplotlib."""
from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np

from ..config import Mode, load_config
from ..solver import make_schedule
from ..utils.pcv import require_pyplot


def schedule_samples(cfg) -> Tuple[np.ndarray, List[float]]:
    """(iterations, learning rates) of the schedule of ``cfg`` (a loaded
    training Config) at np.linspace(0, max_it, 2000, dtype=int)."""
    schedule = make_schedule(cfg.to_dict())
    max_it = cfg.optimizer.max_iterations or 100000
    steps = np.linspace(0, max_it, 2000, dtype=int)
    return steps, [float(schedule(int(s))) for s in steps]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Plot the LR schedule.")
    parser.add_argument("config", type=str, help="training configuration (*.yaml)")
    parser.add_argument("--output", type=str, default="lr_schedule.png")
    args = parser.parse_args(argv)

    plt = require_pyplot("Agg")
    steps, lrs = schedule_samples(load_config(args.config, Mode.TEST))
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(steps, lrs)
    ax.set_xlabel("iteration")
    ax.set_ylabel("learning rate")
    ax.set_yscale("log")
    fig.savefig(args.output, bbox_inches="tight")
    print(f"saved {args.output}")


if __name__ == "__main__":
    main()
