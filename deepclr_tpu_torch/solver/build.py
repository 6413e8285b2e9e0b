"""Optimizer and schedule factories from a training config dict (the
``optimizer`` and ``scheduler`` sections of a training YAML, e.g.
``configs.KITTI_TRAIN_CFG``).

One learning rate for every parameter: ``bias_lr_factor`` is ignored on
purpose.  With any per-iteration scheduler (every shipped config) the
reference's scheduler overwrites each parameter group's lr every step, so
the factor never takes effect.  The trainer writes the schedule's value into
``param_groups[*]["lr"]`` before each step.
"""
from __future__ import annotations

from .optimizers import Adam, Ranger
from .schedulers import Schedule, make_schedule_fn

__all__ = ["make_optimizer", "make_schedule"]

_OPTIMIZERS = {"Ranger": Ranger, "Adam": Adam}


def make_optimizer(cfg, params):
    """The optimizer named by ``cfg["optimizer"]["name"]`` over ``params``,
    at ``base_lr`` with ``weight_decay`` and the section's extra ``params``."""
    opt = cfg["optimizer"]
    name = opt.get("name", "Adam")
    if name not in _OPTIMIZERS:
        raise NotImplementedError(f"Unknown optimizer '{name}'")
    return _OPTIMIZERS[name](params, lr=float(opt.get("base_lr", 1e-4)),
                             weight_decay=float(opt.get("weight_decay", 0.0)),
                             **dict(opt.get("params") or {}))


def make_schedule(cfg) -> Schedule:
    """The step -> lr schedule of ``cfg["scheduler"]``; none -> constant base_lr."""
    sched = cfg.get("scheduler") or {}
    return make_schedule_fn(sched.get("name"), dict(sched.get("params") or {}),
                            float(cfg["optimizer"].get("base_lr", 1e-4)))
