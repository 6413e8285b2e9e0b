"""Synthetic KITTI-like clouds and training batches, made from a seed.

The clouds have the statistics of ``bench.py``'s synthetic KITTI scans
(normal, sigma = 30, 30, 2 m, plus a uniform intensity channel).  Used by
``chip_smoke.py`` and the profiling scripts; no part of the model reads them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .geometry import se3

__all__ = ["kitti_like", "train_batch"]


def kitti_like(batch: int, n: int, seed: int) -> np.ndarray:
    """(batch, n, 4) float32: xyz with KITTI-like extent (~120 x 120 x 8 m)
    and an intensity in [0, 1)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(batch, n, 3)).astype(np.float32) * np.array([30.0, 30.0, 2.0], np.float32)
    extra = rng.uniform(0.0, 1.0, size=(batch, n, 1)).astype(np.float32)
    return np.concatenate([pts, extra], axis=-1)


def train_batch(batch: int, n: int, seed: int) -> Dict[str, np.ndarray]:
    """A training batch: KITTI-like templates, sources moved by random small
    rigid motions (up to a few degrees and ~1 m), dual-quaternion labels."""
    rng = np.random.default_rng(seed)
    t = kitti_like(batch, n, seed)
    angles = torch.from_numpy((rng.normal(size=(3, batch)) * 0.03).astype(np.float32))
    shift = torch.from_numpy((rng.normal(size=(batch, 3)) * [1.0, 0.3, 0.05]).astype(np.float32))
    m = se3.make_transform(se3.euler_to_matrix(*angles), shift)
    src = t.copy()
    src[..., :3] = se3.transform_points(m, torch.from_numpy(t[..., :3])).numpy()
    mask = np.ones((batch, n), bool)
    return {"template": t, "source": src, "template_mask": mask, "source_mask": mask,
            "y": se3.dualquat_from_matrix(m).numpy()}
