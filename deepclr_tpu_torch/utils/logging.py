"""Logging: a stdout logger with an optional timestamped file in a run
directory (non-zero distributed ranks stay silent), and the summary writer
of a training run.

The summary writer always writes the JSONL sink ``scalars.jsonl`` (so a
headless run keeps its metrics) and, when ``torch.utils.tensorboard``
imports, TensorBoard event files beside it.  matplotlib is imported only
inside ``add_figure``, whose caller made the figure with it.
"""
from __future__ import annotations

import json
import logging
import os
import os.path as osp
import sys
import time
from typing import Optional

__all__ = ["create_logger", "create_summary_writer", "SummaryWriter"]


def create_logger(name: str = "deepclr", save_dir: Optional[str] = None,
                  distributed_rank: int = 0) -> logging.Logger:
    """Stdout + file logger; a logger that already has handlers is returned
    as it is."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if distributed_rank > 0:
        return logger
    if logger.handlers:
        return logger

    formatter = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setLevel(logging.DEBUG)
    ch.setFormatter(formatter)
    logger.addHandler(ch)

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        fh = logging.FileHandler(osp.join(save_dir, f"log_{stamp}.txt"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(formatter)
        logger.addHandler(fh)

    return logger


class _JsonlWriter:
    """Scalar sink: one JSON line per event."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(osp.join(logdir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class SummaryWriter:
    """The JSONL sink, plus TensorBoard when it imports, behind one
    interface; only TensorBoard keeps figures."""

    def __init__(self, logdir: str):
        self._jsonl = _JsonlWriter(logdir)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter
        except ImportError:
            pass
        else:
            self._tb = TBWriter(logdir)

    @property
    def _writers(self):
        return [self._jsonl] if self._tb is None else [self._jsonl, self._tb]

    def add_scalar(self, tag, value, step):
        for w in self._writers:
            w.add_scalar(tag, value, step)

    def add_figure(self, tag, figure, step=0):
        if self._tb is not None:
            self._tb.add_figure(tag, figure, step)
        import matplotlib.pyplot as plt

        plt.close(figure)

    def flush(self):
        for w in self._writers:
            w.flush()

    def close(self):
        for w in self._writers:
            w.close()


def create_summary_writer(logdir: str) -> SummaryWriter:
    return SummaryWriter(logdir)
