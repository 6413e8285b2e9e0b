"""Optimizers (Ranger, Adam) and learning-rate schedules of the train step."""
from .build import make_optimizer, make_schedule
from .optimizers import Adam, Ranger
from .schedulers import cyclic_flat_cosine, cyclic_lr, make_schedule_fn

__all__ = ["Adam", "Ranger", "cyclic_flat_cosine", "cyclic_lr", "make_optimizer",
           "make_schedule", "make_schedule_fn"]
