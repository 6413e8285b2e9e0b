"""Learning-rate schedules as pure functions of the step counter.

CyclicLRWithFlatAndCosineAnnealing: a torch CyclicLR phase, then a flat
phase at the cyclic base lr, then cosine annealing to zero.  A pure
``step -> lr`` function composes with any stepping policy (per iteration,
per epoch, per validation); the trainer writes its value into the optimizer
before each step.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

__all__ = ["cyclic_lr", "cyclic_flat_cosine", "make_schedule_fn"]

Schedule = Callable[[int], float]


def cyclic_lr(base_lr: float, max_lr: float, step_size_up: int = 2000,
              step_size_down: Optional[int] = None, mode: str = "triangular",
              gamma: float = 1.0) -> Schedule:
    """torch.optim.lr_scheduler.CyclicLR as a pure schedule."""
    up = int(step_size_up)
    down = int(step_size_down) if step_size_down is not None else up
    total = up + down

    def schedule(step: int) -> float:
        cycle = math.floor(1 + step / total)
        pos = step - (cycle - 1) * total
        x = pos / up if pos <= up else 1.0 - (pos - up) / down
        if mode == "triangular":
            scale = 1.0
        elif mode == "triangular2":
            scale = 1.0 / (2.0 ** (cycle - 1))
        elif mode == "exp_range":
            scale = gamma ** step
        else:  # pragma: no cover
            raise ValueError(f"Unknown cyclic mode '{mode}'")
        return base_lr + (max_lr - base_lr) * max(0.0, x) * scale

    return schedule


def cyclic_flat_cosine(cyclic_iterations: int, flat_iterations: int,
                       annealing_iterations: int, base_lr: float,
                       max_lr: float, step_size_up: int = 2000,
                       step_size_down: Optional[int] = None,
                       mode: str = "triangular", gamma: float = 1.0,
                       **_ignored) -> Schedule:
    """Cyclic -> flat (at base_lr) -> cosine annealing (to 0)."""
    cyc = cyclic_lr(base_lr, max_lr, step_size_up, step_size_down, mode, gamma)

    def schedule(step: int) -> float:
        if step < cyclic_iterations:
            return cyc(step)
        if step < cyclic_iterations + flat_iterations:
            return base_lr
        t = step - cyclic_iterations - flat_iterations
        if t >= annealing_iterations:
            return 0.0
        return base_lr * (1.0 + math.cos(math.pi * t / annealing_iterations)) / 2.0

    return schedule


_SCHEDULES = {
    "CyclicLRWithFlatAndCosineAnnealing": cyclic_flat_cosine,
    "CyclicLR": cyclic_lr,
}


def make_schedule_fn(name: Optional[str], params: dict,
                     default_lr: float) -> Schedule:
    """Named schedule from config; None -> constant at the optimizer lr."""
    if name is None:
        return lambda step: default_lr
    if name not in _SCHEDULES:
        raise NotImplementedError(f"Unknown scheduler '{name}'")
    return _SCHEDULES[name](**params)
