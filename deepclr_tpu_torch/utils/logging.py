"""Logging: a stdout logger with an optional timestamped file in a run
directory.  Non-zero distributed ranks stay silent."""
from __future__ import annotations

import logging
import os
import os.path as osp
import sys
import time
from typing import Optional

__all__ = ["create_logger"]


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
