"""The port's synthetic scans and CAD clouds (deepclr_tpu_torch.data.synthetic)
against the JAX package's on the CPU: both are numpy drawing from one seeded
Generator in the same order, so every cloud is held bit for bit.  The
ray casts run at reduced azimuth counts; ``drive`` is held against the JAX
package's synthetic KITTI writer (``scripts/make_synthetic_kitti.py``)."""
import importlib.util
import os.path as osp

import numpy as np
import pytest

pytest.importorskip("torch")

from deepclr_tpu.data import synthetic as js  # noqa: E402
from deepclr_tpu_torch.data import synthetic as ps  # noqa: E402

REPO = osp.realpath(osp.join(osp.dirname(__file__), ".."))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [0, 1, 25])
def test_make_scene_equals_jax(n):
    for g, r in zip(ps.make_scene(np.random.default_rng(n), n), js.make_scene(np.random.default_rng(n), n)):
        _same(g, r)


@pytest.mark.parametrize("num_points", [500, 20000])  # fewer and more points than rays hit
def test_lidar_scan_equals_jax(num_points):
    pose = js.random_motion(np.random.default_rng(3)).astype(np.float64)
    kw = dict(n_azimuths=128, noise=0.03)
    got = ps.lidar_scan(np.random.default_rng(1), num_points, sensor_pose=pose, **kw)
    ref = js.lidar_scan(np.random.default_rng(1), num_points, sensor_pose=pose, **kw)
    _same(got, ref)
    assert got.shape == (num_points, 4)


def test_random_motion_and_lidar_pair_equal_jax():
    _same(ps.random_motion(np.random.default_rng(2), 2.0, 5.0), js.random_motion(np.random.default_rng(2), 2.0, 5.0))
    got = ps.lidar_pair(np.random.default_rng(4), 3000, n_azimuths=256, n_obstacles=12)
    ref = js.lidar_pair(np.random.default_rng(4), 3000, n_azimuths=256, n_obstacles=12)
    for g, r in zip(got, ref):
        _same(g, r)


@pytest.mark.parametrize("seed", range(6))  # every primitive kind comes up
def test_cad_cloud_equals_jax(seed):
    _same(ps.cad_cloud(np.random.default_rng(seed), 777), js.cad_cloud(np.random.default_rng(seed), 777))


def test_drive_equals_the_jax_synthetic_kitti_writer():
    spec = importlib.util.spec_from_file_location("make_synthetic_kitti", osp.join(REPO, "scripts",
                                                                                   "make_synthetic_kitti.py"))
    writer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(writer)
    poses = writer.trajectory(np.random.default_rng(7), 6, speed=1.5)
    for g, r in zip(ps.trajectory(np.random.default_rng(7), 6, speed=1.5), poses):
        _same(g, r)

    # the writer's scene and scans, with the drive's draws, at 256 azimuths
    rng = np.random.default_rng(9)
    poses = writer.trajectory(rng, 4)
    span = np.array([p[:3, 3] for p in poses])
    lo, hi = span.min(0) - 50, span.max(0) + 50
    n_obs = max(60, int((hi[0] - lo[0]) * (hi[1] - lo[1]) / 400))
    obs_lo, obs_hi = js.make_scene(rng, n_obstacles=n_obs)
    shift = rng.uniform(lo[:2], hi[:2], (n_obs, 2)) - (obs_lo[:, :2] + obs_hi[:, :2]) / 2
    obs_lo[:, :2] += shift
    obs_hi[:, :2] += shift
    ref = [(p, js.lidar_scan(rng, 2000, scene=(obs_lo, obs_hi), sensor_pose=p, n_azimuths=256)) for p in poses]
    got = list(ps.drive(np.random.default_rng(9), 4, 2000, n_azimuths=256))
    assert len(got) == 4
    for (gp, gc), (rp, rc) in zip(got, ref):
        _same(gp, rp)
        _same(gc, rc)
