"""CAD-like surface clouds, a stand-in for ModelNet40's models.

A frozen copy of ``deepclr_tpu_torch/data/synthetic.py``'s ``cad_cloud``
and its primitive samplers (box, cylinder, sphere, torus): a union of
1-3 randomly placed primitives, sampled on their surfaces with normals
and normalised to the unit sphere.  Copied so that the benchmark's shapes
stay fixed whatever the program's generator becomes.
"""
from __future__ import annotations

import numpy as np


def _sample_box(rng, n, half):
    areas = np.array([half[1] * half[2], half[0] * half[2], half[0] * half[1]]).repeat(2)
    face = rng.choice(6, n, p=areas / areas.sum())
    axis = face // 2
    sign = np.where(face % 2 == 0, 1.0, -1.0)
    pts = rng.uniform(-1, 1, (n, 3)) * half
    normals = np.zeros((n, 3))
    rows = np.arange(n)
    pts[rows, axis] = sign * half[axis]
    normals[rows, axis] = sign
    return pts, normals


def _sample_cylinder(rng, n, r, h):
    a_side = 2 * np.pi * r * h
    a_cap = np.pi * r * r
    part = rng.choice(3, n, p=np.array([a_side, a_cap, a_cap]) / (a_side + 2 * a_cap))
    phi = rng.uniform(0, 2 * np.pi, n)
    pts = np.zeros((n, 3))
    normals = np.zeros((n, 3))
    side = part == 0
    pts[side] = np.stack([r * np.cos(phi[side]), r * np.sin(phi[side]),
                          rng.uniform(-h / 2, h / 2, side.sum())], 1)
    normals[side] = np.stack([np.cos(phi[side]), np.sin(phi[side]), np.zeros(side.sum())], 1)
    for which, z, nz in ((part == 1, h / 2, 1.0), (part == 2, -h / 2, -1.0)):
        m = int(which.sum())
        rr = r * np.sqrt(rng.uniform(0, 1, m))
        pts[which] = np.stack([rr * np.cos(phi[which]), rr * np.sin(phi[which]), np.full(m, z)], 1)
        normals[which] = np.array([0.0, 0.0, nz])
    return pts, normals


def _sample_sphere(rng, n, r):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
    return v * r, v


def _sample_torus(rng, n, big_r, small_r):
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    cu, su, cv, sv = np.cos(u), np.sin(u), np.cos(v), np.sin(v)
    pts = np.stack([(big_r + small_r * cv) * cu, (big_r + small_r * cv) * su, small_r * sv], 1)
    normals = np.stack([cv * cu, cv * su, sv], 1)
    return pts, normals


_PRIMS = ["box", "cylinder", "sphere", "torus"]


def cad_cloud(rng: np.random.Generator, num_points: int, n_parts: int = 3) -> np.ndarray:
    """(num_points, 6) [xyz | normal] surface samples of a random union of
    primitives, normalised to the unit sphere: a stand-in for a
    PointNet++-preprocessed ModelNet40 model (xyz + normals)."""
    parts = rng.integers(1, n_parts + 1)
    per = np.full(parts, num_points // parts)
    per[:num_points - per.sum()] += 1
    chunks = []
    for m in per:
        kind = _PRIMS[rng.integers(len(_PRIMS))]
        if kind == "box":
            pts, nrm = _sample_box(rng, m, rng.uniform(0.2, 1.0, 3))
        elif kind == "cylinder":
            pts, nrm = _sample_cylinder(rng, m, rng.uniform(0.15, 0.6), rng.uniform(0.4, 1.6))
        elif kind == "sphere":
            pts, nrm = _sample_sphere(rng, m, rng.uniform(0.2, 0.8))
        else:
            pts, nrm = _sample_torus(rng, m, rng.uniform(0.4, 0.9), rng.uniform(0.1, 0.3))
        # random placement
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        rot = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        offset = rng.uniform(-0.5, 0.5, 3)
        chunks.append(np.concatenate([pts @ rot.T + offset, nrm @ rot.T], 1))
    cloud = np.concatenate(chunks, 0)
    center = cloud[:, :3].mean(0)
    cloud[:, :3] -= center
    scale = np.linalg.norm(cloud[:, :3], axis=1).max() + 1e-9
    cloud[:, :3] /= scale
    return cloud.astype(np.float32)
