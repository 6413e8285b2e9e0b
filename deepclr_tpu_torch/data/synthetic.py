"""Synthetic LiDAR scans with the density of a Velodyne HDL-64, and
CAD-like surface clouds.

No real dataset ships with the repository, so density-sensitive work
(the kernels at realistic ball populations, loader throughput, training
runs from a YAML) needs clouds whose local density resembles a real scan:
dense ground rings near the sensor (hundreds of points in a 0.5 m ball),
sparse returns far out, vertical structures.

``lidar_scan`` ray-casts a procedural scene (a ground plane and random
vertical boxes) with the HDL-64 beam geometry: 64 elevations from +2 to
-24.8 degrees, ``n_azimuths`` a revolution.  ``lidar_pair`` scans one scene
from two sensor poses related by a random rigid motion (template_cloud ~
motion @ source_cloud, the data pipeline's label convention), and
``drive`` moves the sensor along a smooth path through one persistent
scene, as a KITTI odometry sequence does.  ``cad_cloud`` samples a union of
primitives with normals, a stand-in for a ModelNet40 model.  Every draw
comes from the ``np.random.Generator`` passed in, in the JAX package's
order, so a seed gives the same clouds in both packages.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from ..geometry.hostmath import _euler_to_matrix_np

__all__ = ["make_scene", "lidar_scan", "lidar_pair", "random_motion", "cad_cloud", "trajectory", "drive"]

_SENSOR_HEIGHT = 1.73  # m, the KITTI velodyne's mount height
_MAX_RANGE = 80.0


def make_scene(rng: np.random.Generator, n_obstacles: int = 40):
    """Random scene: (lo, hi) corner arrays of vertical boxes in the world
    frame (origin at the first sensor position, ground at z = -sensor
    height)."""
    cx = rng.uniform(-45, 45, n_obstacles)
    cy = rng.uniform(-45, 45, n_obstacles)
    half = rng.uniform(0.5, 4.0, (n_obstacles, 2))
    top = rng.uniform(0.5, 6.0, n_obstacles) - _SENSOR_HEIGHT
    lo = np.stack([cx - half[:, 0], cy - half[:, 1], np.full(n_obstacles, -_SENSOR_HEIGHT)], axis=1)
    hi = np.stack([cx + half[:, 0], cy + half[:, 1], top], axis=1)
    return lo, hi


def lidar_scan(
    rng: np.random.Generator,
    num_points: int,
    scene=None,
    sensor_pose: Optional[np.ndarray] = None,
    n_beams: int = 64,
    n_azimuths: int = 2048,
    noise: float = 0.02,
) -> np.ndarray:
    """One scan in the sensor frame, (num_points, 4) float32 [x, y, z,
    intensity].

    ``sensor_pose`` (4, 4) maps sensor to world coordinates (identity when
    omitted).  Rays that hit nothing in range are dropped; the hits are
    randomly subsampled (or repeated) to ``num_points``.
    """
    if scene is None:
        scene = make_scene(rng)
    lo_all, hi_all = scene
    if sensor_pose is None:
        sensor_pose = np.eye(4, dtype=np.float64)
    rot = sensor_pose[:3, :3]
    origin = sensor_pose[:3, 3]

    elev = np.deg2rad(np.linspace(2.0, -24.8, n_beams))
    azim = rng.uniform(0, 2 * np.pi) + np.linspace(0, 2 * np.pi, n_azimuths, endpoint=False)
    az, el = np.meshgrid(azim, elev)
    az = az.ravel()
    el = el.ravel()
    d_sensor = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=1)
    d = d_sensor @ rot.T  # world frame

    # ground plane z = -h
    with np.errstate(divide="ignore"):
        t_ground = np.where(d[:, 2] < -1e-6, (-_SENSOR_HEIGHT - origin[2]) / d[:, 2], np.inf)
    t_hit = t_ground

    # vertical boxes, slab method, one axis at a time with in-place running
    # min / max
    with np.errstate(divide="ignore"):
        inv = 1.0 / d
    n_rays = d.shape[0]
    for lo, hi in zip(lo_all, hi_all):
        tmin = np.full(n_rays, -np.inf)
        tmax = np.full(n_rays, np.inf)
        for k in range(3):
            with np.errstate(invalid="ignore"):
                a = (lo[k] - origin[k]) * inv[:, k]
                b = (hi[k] - origin[k]) * inv[:, k]
            np.maximum(tmin, np.minimum(a, b), out=tmin)
            np.minimum(tmax, np.maximum(a, b), out=tmax)
        hit = (tmax >= tmin) & (tmin > 0.5)
        t_hit = np.where(hit & (tmin < t_hit), tmin, t_hit)

    valid = t_hit < _MAX_RANGE
    t = t_hit[valid] + rng.normal(0, noise, int(valid.sum()))
    pts = d_sensor[valid] * t[:, None]  # sensor frame

    if pts.shape[0] >= num_points:
        sel = rng.choice(pts.shape[0], num_points, replace=False)
    else:
        sel = rng.choice(pts.shape[0], num_points, replace=True)
    pts = pts[sel]
    intensity = rng.uniform(0, 1, (num_points, 1))
    return np.concatenate([pts, intensity], axis=1).astype(np.float32)


def random_motion(rng: np.random.Generator, max_translation: float = 1.5,
                  max_rotation_deg: float = 3.0) -> np.ndarray:
    """Random SE(3) motion at KITTI frame-to-frame scale, (4, 4) float32."""
    angles = np.deg2rad(rng.uniform(-max_rotation_deg, max_rotation_deg, 3))
    m = np.eye(4)
    m[:3, :3] = _euler_to_matrix_np(*angles)
    # forward-dominated translation, as between consecutive odometry frames
    m[0, 3] = rng.uniform(0, max_translation)
    m[1, 3] = rng.uniform(-0.2, 0.2) * max_translation
    m[2, 3] = rng.uniform(-0.05, 0.05) * max_translation
    return m.astype(np.float32)


def lidar_pair(rng: np.random.Generator, num_points: int, motion: Optional[np.ndarray] = None,
               **scan_kwargs) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(template, source, motion): two scans of one scene whose sensor poses
    differ by ``motion``, each in its own sensor frame.  The template's
    sensor is the world origin and the source's pose is ``motion``, so a
    static point satisfies p_template = motion @ p_source."""
    if motion is None:
        motion = random_motion(rng)
    scene = make_scene(rng, n_obstacles=scan_kwargs.pop("n_obstacles", 40))
    template = lidar_scan(rng, num_points, scene=scene, **scan_kwargs)
    source = lidar_scan(rng, num_points, scene=scene, sensor_pose=motion.astype(np.float64), **scan_kwargs)
    return template, source, motion.astype(np.float32)


def trajectory(rng: np.random.Generator, frames: int, speed: float = 1.2):
    """A smooth driven path: ``frames`` poses (4, 4), ~``speed`` m a frame,
    the yaw rate a damped random walk, a gentle vertical undulation."""
    poses = [np.eye(4)]
    yaw = 0.0
    yaw_rate = 0.0
    for _ in range(frames - 1):
        yaw_rate = 0.9 * yaw_rate + 0.1 * rng.normal(0, 0.02)
        yaw += yaw_rate
        prev = poses[-1]
        step = np.eye(4)
        c, s = np.cos(yaw), np.sin(yaw)
        step[:2, :2] = [[c, -s], [s, c]]
        step[0, 3] = prev[0, 3] + speed * c
        step[1, 3] = prev[1, 3] + speed * s
        step[2, 3] = 0.02 * np.sin(0.05 * len(poses))
        poses.append(step)
    return poses


def drive(rng: np.random.Generator, frames: int, num_points: int, speed: float = 1.2,
          **scan_kwargs) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """A KITTI-like odometry sequence: yields (pose (4, 4) float64, scan
    (num_points, 4) float32) for each of ``frames`` sensor poses along
    ``trajectory``, all scans of one persistent scene whose obstacles are
    spread over the drive's envelope (50 m beyond the path on every side,
    at least 60 boxes, one a 400 m^2).  The draws are those of the JAX
    package's synthetic KITTI writer."""
    poses = trajectory(rng, frames, speed=speed)
    span = np.array([p[:3, 3] for p in poses])
    lo = span.min(0) - 50
    hi = span.max(0) + 50
    n_obs = max(60, int((hi[0] - lo[0]) * (hi[1] - lo[1]) / 400))
    obs_lo, obs_hi = make_scene(rng, n_obstacles=n_obs)
    shift = rng.uniform(lo[:2], hi[:2], (n_obs, 2)) - (obs_lo[:, :2] + obs_hi[:, :2]) / 2
    obs_lo[:, :2] += shift
    obs_hi[:, :2] += shift
    scene = (obs_lo, obs_hi)
    for pose in poses:
        yield pose, lidar_scan(rng, num_points, scene=scene, sensor_pose=pose, **scan_kwargs)


# --- CAD-like surface clouds (a ModelNet40 stand-in) ----------------------------------------------

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
