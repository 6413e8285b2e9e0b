"""Traffic generator: ray-cast HDL-64 scans along a driven path, from a
``np.random.Generator``.

A frozen copy of ``deepclr_tpu_torch/data/synthetic.py`` (``make_scene``,
``lidar_scan``, ``trajectory``, ``drive``) and of the two host helpers it needs from
``deepclr_tpu_torch/geometry/hostmath.py`` (``_euler_to_matrix_np``, the
dual-quaternion branch of ``label_from_matrix_np``).  Kept here so that a
change to the program cannot change the benchmark's inputs.  Two changes:
``lidar_scan(num_points=None)`` keeps every hit, a raw scan of varying size
(the copy draws nothing for it, the original always subsamples); and the
original ``drive``, which draws its path, its boxes and its scans from one
generator, is split in two: ``world`` (the path and the boxes, or a
stretch of a longer drive's path among all its boxes) and ``drive`` (the
scans of a world), each from a generator of its own.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

_SENSOR_HEIGHT = 1.73  # m, the KITTI velodyne's mount height
_MAX_RANGE = 80.0


def euler_to_matrix(roll, pitch, yaw):
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    return np.stack([
        np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1),
        np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1),
        np.stack([-sp, cp * sr, cp * cr], axis=-1),
    ], axis=-2)


def _qmult(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def _matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """Batched rotation matrix -> unit quaternion [w,x,y,z], w >= 0."""
    m = np.asarray(m, float)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = np.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = np.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = np.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = np.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)
    scores = np.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], axis=-1)
    best = np.argmax(scores, axis=-1)
    cands = np.stack([qw, qx, qy, qz], axis=-2)
    q = np.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return q * np.where(q[..., :1] < 0, -1.0, 1.0)


def dual_quat_label(m: np.ndarray) -> np.ndarray:
    """(..., 4, 4) transform -> (..., 8) dual-quaternion label [real | dual]."""
    m = np.asarray(m, float)
    t = m[..., :3, 3]
    real = _matrix_to_quat(m[..., :3, :3])
    tq = np.concatenate([np.zeros_like(t[..., :1]), t], axis=-1)
    return np.concatenate([real, 0.5 * _qmult(tq, real)], axis=-1)


def make_scene(rng: np.random.Generator, n_obstacles: int = 40):
    """Random scene: (lo, hi) corner arrays of vertical boxes."""
    cx = rng.uniform(-45, 45, n_obstacles)
    cy = rng.uniform(-45, 45, n_obstacles)
    half = rng.uniform(0.5, 4.0, (n_obstacles, 2))
    top = rng.uniform(0.5, 6.0, n_obstacles) - _SENSOR_HEIGHT
    lo = np.stack([cx - half[:, 0], cy - half[:, 1], np.full(n_obstacles, -_SENSOR_HEIGHT)], axis=1)
    hi = np.stack([cx + half[:, 0], cy + half[:, 1], top], axis=1)
    return lo, hi


def lidar_scan(rng: np.random.Generator, num_points: Optional[int], scene=None,
               sensor_pose: Optional[np.ndarray] = None, n_beams: int = 64, n_azimuths: int = 2048,
               noise: float = 0.02) -> np.ndarray:
    """One scan in the sensor frame, (n, 4) float32 [x, y, z, intensity]:
    64 elevations from +2 to -24.8 degrees, ``n_azimuths`` a revolution, a
    ground plane and vertical boxes, hits within 80 m.  The hits are
    subsampled (or repeated) to ``num_points``; ``None`` keeps them all."""
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
    d = d_sensor @ rot.T

    with np.errstate(divide="ignore"):
        t_ground = np.where(d[:, 2] < -1e-6, (-_SENSOR_HEIGHT - origin[2]) / d[:, 2], np.inf)
    t_hit = t_ground
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
    pts = d_sensor[valid] * t[:, None]
    if num_points is None:
        num_points = pts.shape[0]
    else:
        pts = pts[rng.choice(pts.shape[0], num_points, replace=pts.shape[0] < num_points)]
    intensity = rng.uniform(0, 1, (num_points, 1))
    return np.concatenate([pts, intensity], axis=1).astype(np.float32)


def trajectory(rng: np.random.Generator, frames: int, speed: float = 1.2):
    """A smooth driven path: ``frames`` poses (4, 4), ~``speed`` m a frame."""
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


def world(rng: np.random.Generator, frames: int, speed: float = 1.2, drive_frames: Optional[int] = None):
    """A drive's world: ``frames`` consecutive sensor poses (4, 4) of a
    ``drive_frames``-pose ``trajectory`` (no fewer than ``frames``) and one
    persistent scene of boxes spread over the whole drive's envelope.  Of a
    longer drive, the poses start at a frame drawn after the boxes."""
    total = max(frames, drive_frames or 0)
    poses = trajectory(rng, total, speed=speed)
    span = np.array([p[:3, 3] for p in poses])
    lo = span.min(0) - 50
    hi = span.max(0) + 50
    n_obs = max(60, int((hi[0] - lo[0]) * (hi[1] - lo[1]) / 400))
    obs_lo, obs_hi = make_scene(rng, n_obstacles=n_obs)
    shift = rng.uniform(lo[:2], hi[:2], (n_obs, 2)) - (obs_lo[:, :2] + obs_hi[:, :2]) / 2
    obs_lo[:, :2] += shift
    obs_hi[:, :2] += shift
    first = int(rng.integers(0, total - frames + 1)) if total > frames else 0
    return poses[first:first + frames], (obs_lo, obs_hi)


def drive(rng: np.random.Generator, world, num_points: Optional[int],
          **scan_kwargs) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """An odometry sequence through ``world`` (poses, scene): (pose (4, 4)
    float64, scan) at each pose, every scan's draws from ``rng``."""
    poses, scene = world
    for pose in poses:
        yield pose, lidar_scan(rng, num_points, scene=scene, sensor_pose=pose, **scan_kwargs)
