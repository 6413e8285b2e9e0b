"""Synthetic KITTI-like clouds and training batches, made from a seed.

The clouds have the statistics of ``bench.py``'s synthetic KITTI scans
(normal, sigma = 30, 30, 2 m, plus a uniform intensity channel).
``cad_train_batch`` is the ModelNet40 recipe's batch on CAD-like clouds
(``data/synthetic.py::cad_cloud``).  Used by ``chip_smoke.py`` and the
profiling scripts; no part of the model reads them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .data.synthetic import cad_cloud
from .geometry import se3
from .geometry.hostmath import _euler_to_matrix_np

__all__ = ["cad_train_batch", "kitti_like", "kitti_like_sequence", "train_batch"]


def kitti_like(batch: int, n: int, seed: int) -> np.ndarray:
    """(batch, n, 4) float32: xyz with KITTI-like extent (~120 x 120 x 8 m)
    and an intensity in [0, 1)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(batch, n, 3)).astype(np.float32) * np.array([30.0, 30.0, 2.0], np.float32)
    extra = rng.uniform(0.0, 1.0, size=(batch, n, 1)).astype(np.float32)
    return np.concatenate([pts, extra], axis=-1)


def kitti_like_sequence(n_frames: int, n: int, seed: int):
    """A drive through one KITTI-like scene of ``n`` points: the pose
    advances by a small random rigid motion a frame (~1 m forward, a few
    tenths of a degree of turn), and frame i sees the scene in its own
    coordinates with 1 cm of sensor noise.  Returns (clouds: n_frames
    (n, 4) float32 arrays, poses: n_frames (4, 4) float64 arrays)."""
    rng = np.random.default_rng(seed)
    scene = kitti_like(1, n, seed)[0]
    pose = np.eye(4)
    clouds, poses = [], []
    for _ in range(n_frames):
        local = scene.copy()
        local[:, :3] = ((scene[:, :3] - pose[:3, 3]) @ pose[:3, :3]).astype(np.float32)
        local[:, :3] += rng.normal(size=(n, 3)).astype(np.float32) * 0.01
        clouds.append(local)
        poses.append(pose.copy())
        yaw = rng.normal() * 0.005
        step = np.eye(4)
        step[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        step[:3, 3] = [1.0 + 0.1 * rng.normal(), 0.05 * rng.normal(), 0.01 * rng.normal()]
        pose = pose @ step
    return clouds, poses


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


def cad_train_batch(batch: int, n: int, seed: int) -> Dict[str, np.ndarray]:
    """A ModelNet40 training batch: self-pairs of CAD-like clouds of ``n``
    xyz points, the source the template moved by the inverse of the
    recipe's motion M (translation U(-0.1, 0.1) m and rotation U(-5, 5)
    degrees an axis, ``configs/training/modelnet40.yaml``), both with the
    recipe's N(0, 0.02) point noise; the label is M."""
    rng = np.random.default_rng(seed)
    t = np.stack([cad_cloud(rng, n)[:, :3] for _ in range(batch)])
    m = np.tile(np.eye(4), (batch, 1, 1))
    for i in range(batch):
        m[i, :3, 3] = rng.uniform(-0.1, 0.1, 3)
        m[i, :3, :3] = _euler_to_matrix_np(*np.deg2rad(rng.uniform(-5.0, 5.0, 3)))
    inv = np.linalg.inv(m)
    src = np.einsum("bij,bnj->bni", inv[:, :3, :3], t) + inv[:, None, :3, 3]
    t = (t + rng.normal(0.0, 0.02, t.shape)).astype(np.float32)
    src = (src + rng.normal(0.0, 0.02, src.shape)).astype(np.float32)
    mask = np.ones((batch, n), bool)
    return {"template": t, "source": src, "template_mask": mask, "source_mask": mask,
            "y": se3.dualquat_from_matrix(torch.from_numpy(m.astype(np.float32))).numpy()}
