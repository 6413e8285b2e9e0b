"""The port's ICP baselines (deepclr_tpu_torch.icp) against the JAX
package's on the CPU.

Tolerances: both sides are float32 with other summation orders and other
LAPACK paths (eigh, SVD, solve), so the registrations agree to 1e-4 in
every entry of the 4x4 transform and to one iteration (the convergence test
compares the update with epsilon, and a last update near epsilon may fall
either side).  Normals agree up to sign to 1e-5 in |cos|, covariances to
2e-5.  The chunked nearest-neighbour search is exact: on grid-valued points
every distance is an integer, and the indices (ties included) and distances
must be equal.  The surface clouds are those of tests/icp/test_gicp_parity.py,
where no neighbourhood is line-like, so no two smallest eigenvalues tie and
the normals are well defined.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepclr_tpu.icp import ICPAlgorithm as JaxAlgorithm  # noqa: E402
from deepclr_tpu.icp import ICPRegistration as JaxRegistration  # noqa: E402
from deepclr_tpu.icp import estimate_covariances as jax_covariances  # noqa: E402
from deepclr_tpu.icp import estimate_normals as jax_normals  # noqa: E402
from deepclr_tpu.ops import knn as jax_knn  # noqa: E402
from deepclr_tpu_torch import ops  # noqa: E402
from deepclr_tpu_torch.data import PackWriter  # noqa: E402
from deepclr_tpu_torch.icp import (  # noqa: E402
    ICPAlgorithm,
    ICPRegistration,
    estimate_covariances,
    estimate_normals,
    knn_block_size,
    nearest_neighbors,
)
from deepclr_tpu_torch.icp.icp import _gicp_whitening  # noqa: E402
from tests.icp.test_gicp_parity import CASES, _gt, _surface_cloud  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-4


def _pair(case, n):
    kind, seed, yaw, t = case
    cloud = _surface_cloud(n, seed, kind)
    gt = _gt(yaw, t)
    return cloud, (cloud @ gt[:3, :3].T + gt[:3, 3]).astype(np.float32)


@pytest.mark.parametrize("algorithm", list(ICPAlgorithm))
@pytest.mark.parametrize("case,n", zip(CASES, (512, 1024, 2048)))
def test_registration_matches_jax(algorithm, case, n):
    template, source = _pair(case, n)
    jreg = JaxRegistration(JaxAlgorithm(algorithm.value), max_distance=2.0)
    want, winfo = jreg.register(jreg.prepare(template), jreg.prepare(source), return_info=True)
    reg = ICPRegistration(algorithm, max_distance=2.0, device="cpu")
    got, info = reg.register(reg.prepare(template), reg.prepare(source), return_info=True)
    assert got.dtype == np.float32 and got.shape == (4, 4)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert abs(info["iterations"] - winfo["iterations"]) <= 1, (info, winfo)
    assert info["final_delta"] < 1e-3 and info["host_read_ms"] >= 0.0


def test_normals_and_covariances_match_jax():
    cloud = _surface_cloud(1000, 10, "wave")
    padded = np.zeros((1024, 3), np.float32)
    padded[:1000] = cloud
    mask = np.arange(1024) < 1000
    pts = torch.from_numpy(cloud)
    got = estimate_normals(pts, k=30, block=300).numpy()
    want = np.asarray(jax_normals(jnp.asarray(padded), jnp.asarray(mask), k=30))[:1000]
    cos = np.abs((got * want).sum(-1))
    assert cos.min() > 1 - 1e-5
    got = estimate_covariances(pts, k=20, block=300).numpy()
    want = np.asarray(jax_covariances(jnp.asarray(padded), jnp.asarray(mask), k=20))[:1000]
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def _grid(n, seed):
    return np.round(np.random.default_rng(seed).normal(size=(n, 3)) * 3).astype(np.float32)


@pytest.mark.parametrize("k", [1, 8, 30])
def test_chunked_neighbors_equal_the_full_search(k):
    """Grid points: many equal distances, so the lowest-index rule decides;
    a block of 37 does not divide the 300 queries."""
    query, points = torch.from_numpy(_grid(300, 1)), torch.from_numpy(_grid(1000, 2))
    idx, d2 = nearest_neighbors(query, points, k, block=37)
    ref_idx, ref_d2 = ops.knn(query[None], points[None], k)
    assert torch.equal(idx, ref_idx[0]) and torch.equal(d2, ref_d2[0])
    j_idx, j_d2 = jax_knn(query.numpy()[None], points.numpy()[None], k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx)[0])
    np.testing.assert_array_equal(d2.numpy(), np.asarray(j_d2)[0])
    same = nearest_neighbors(query, points, k)
    assert torch.equal(same[0], idx) and torch.equal(same[1], d2)


@pytest.mark.parametrize("k", [1, 8, 30])
def test_masked_points_are_never_chosen_while_k_valid_points_exist(k):
    query, points = torch.from_numpy(_grid(200, 3)), torch.from_numpy(_grid(500, 4))
    mask = torch.from_numpy(np.random.default_rng(5).random(500) < 0.5)
    idx, d2 = nearest_neighbors(query, points, k, points_mask=mask, block=64)
    assert bool(mask[idx].all())
    j_idx, j_d2 = jax_knn(query.numpy()[None], points.numpy()[None], k, points_mask=mask.numpy()[None])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx)[0])
    np.testing.assert_array_equal(d2.numpy(), np.asarray(j_d2)[0])
    # fewer valid points than k: the valid ones first, then the lowest masked indices
    few = torch.zeros(500, dtype=torch.bool)
    few[[7, 300]] = True
    idx, _ = nearest_neighbors(query, points, 4, points_mask=few, block=64)
    assert set(idx[:, :2].flatten().tolist()) <= {7, 300} and idx[:, 2:].tolist() == [[0, 1]] * 200


def test_block_size_follows_the_scratch_budget():
    """A 2 GiB scratch at 32 bytes an entry: 1024 queries against a padded
    scan of 65536 points, 1118 against 60000, never fewer than one."""
    assert knn_block_size(65536) == 1024 and knn_block_size(60000) == 1118 and knn_block_size(10**12) == 1


def test_sliced_linear_algebra_equals_one_call():
    """The batched 3x3 eigensolver, inverse and Cholesky run on slices of
    4096 matrices (cuSOLVER rejects a scan's worth at once): joined, the
    slices equal one call over all 9000."""
    from deepclr_tpu_torch.icp.icp import _batched

    a = torch.from_numpy(np.random.default_rng(0).normal(size=(9000, 3, 3)).astype(np.float32))
    spd = a @ a.transpose(1, 2) + 0.1 * torch.eye(3)
    for fn in (torch.linalg.eigh, torch.linalg.inv_ex, torch.linalg.cholesky_ex):
        got, want = _batched(fn, spd), fn(spd)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert torch.equal(g, w), fn.__name__


def test_gicp_whitening_of_failed_matrices_is_jax_s():
    """Positive definite, indefinite (Cholesky of the inverse fails: LAPACK's
    NaN triangle, zeroed) and singular after the jitter (the inverse fails)
    covariance sums give JAX's factors: the same L, or all zeros."""
    mats = np.stack([np.diag([0.5, 1.0, 2.0]) + 0.1, np.diag([1.0, 1.0, -5e-4]), -1e-5 * np.eye(3),
                     np.diag([2.0, -1.0, 1.0])]).astype(np.float32)
    idx = torch.arange(4)
    got = _gicp_whitening(torch.from_numpy(mats), torch.zeros(4, 3, 3))(idx, torch.eye(4)).numpy()
    m = jnp.asarray(mats)
    m = 0.5 * (m + jnp.swapaxes(m, -1, -2)) + 1e-5 * jnp.eye(3)
    lw = jnp.swapaxes(jnp.linalg.cholesky(jnp.linalg.inv(m)), -1, -2)
    want = np.asarray(jnp.where(jnp.isfinite(lw), lw, 0.0))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.abs(got[0]).max() > 0 and not got[1:].any()


def test_gicp_survives_indefinite_covariance():
    """The counterpart of tests/icp/test_icp.py's: a dozen template
    covariances made indefinite give a finite, accurate transform, as JAX's
    with the same covariances."""
    from tests.icp.test_icp import _make_cloud, _transform

    cloud = _make_cloud(256, seed=7)
    m_true = _transform(1.0, (0.2, 0.1, 0.0))
    src = (cloud @ m_true[:3, :3].T + m_true[:3, 3]).astype(np.float32)
    bad = np.diag([1.0, 1.0, -5e-4]).astype(np.float32)

    reg = ICPRegistration(ICPAlgorithm.GICP, max_distance=5.0, max_iterations=30, device="cpu")
    t, s = reg.prepare(cloud), reg.prepare(src)
    t["cov"][:12] = torch.from_numpy(bad)
    m = reg.register(t, s)
    assert np.isfinite(m).all()
    err = np.linalg.inv(m_true) @ np.linalg.inv(m)
    assert np.abs(err - np.eye(4)).max() < 0.05

    jreg = JaxRegistration(JaxAlgorithm.GICP, max_distance=5.0, max_iterations=30)
    jt, js = jreg.prepare(cloud), jreg.prepare(src)
    jcov = np.array(jt["cov"])
    jcov[:12] = bad
    jt["cov"] = jnp.asarray(jcov)
    np.testing.assert_allclose(m, jreg.register(jt, js), atol=TOL, rtol=0)


def _write_sequence(path, frames=4, n=1024):
    """A sequence pack of one wave surface seen from poses 0.15 m and 1.5
    degrees apart, each frame its own 1024 samples of the surface."""
    pose = np.eye(4)
    with PackWriter(str(path)) as w:
        for i in range(frames):
            world = _surface_cloud(n, 40 + i, "wave")
            cloud = (world - pose[:3, 3]) @ pose[:3, :3]  # the surface in the frame's coordinates
            w.put(f"{i:06d}", {"idx": i, "timestamp": i * 1e5, "pose": pose.copy(), "cloud": cloud.astype(np.float32)})
            pose = pose @ _gt(1.5, (0.15, 0.05, 0.0))


def test_cli_matches_the_jax_script(tmp_path):
    """``python -m deepclr_tpu_torch.icp ... --device cpu`` against
    ``scripts/icp.py`` on one sequence pack and scenario (GICP, the run_icp.sh
    options): the same files, the same scenario.yaml, stamps and ground truth
    equal, the transforms within 1e-4, every time positive."""
    _write_sequence(tmp_path / "00.pack")
    scenario = tmp_path / "scenario.yaml"
    with open(scenario, "w") as f:
        yaml.dump({"name": "synth_icp", "dataset_type": "kitti_odometry_velodyne", "sequential": True,
                   "data": {"00": str(tmp_path / "00.pack")}}, f)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    args = [str(scenario), "gicp", None, "--max-distance", "1.0"]
    for tag, cmd in (("jax", [sys.executable, str(REPO / "scripts" / "icp.py")]),
                     ("port", [sys.executable, "-m", "deepclr_tpu_torch.icp"])):
        args[2] = str(tmp_path / tag)
        extra = ["--device", "cpu"] if tag == "port" else []
        subprocess.run(cmd + args + extra, env=env, cwd=REPO, check=True, capture_output=True, timeout=300)
    (jdir,), (pdir,) = list((tmp_path / "jax").iterdir()), list((tmp_path / "port").iterdir())
    assert jdir.name.endswith("_synth_icp_GICP") and pdir.name.endswith("_synth_icp_GICP")
    assert sorted(p.name for p in pdir.iterdir()) == sorted(p.name for p in jdir.iterdir()) == ["00.txt",
                                                                                                "scenario.yaml"]
    with open(pdir / "scenario.yaml") as f, open(jdir / "scenario.yaml") as g:
        assert yaml.safe_load(f) == yaml.safe_load(g)
    got, want = np.loadtxt(pdir / "00.txt"), np.loadtxt(jdir / "00.txt")
    assert got.shape == want.shape == (3, 26)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_array_equal(got[:, 13:25], want[:, 13:25])
    np.testing.assert_allclose(got[:, 1:13], want[:, 1:13], atol=TOL, rtol=0)
    assert (got[:, 25] > 0).all()
    # and the registrations are real ones: within 1 cm and 0.05 degrees of the motion
    np.testing.assert_allclose(got[:, 1:13], got[:, 13:25], atol=1e-2)
