"""The port's ball query, masked kNN and 3-NN interpolation against the JAX
package on the CPU: the same numpy inputs through both.  Indices must be
equal.  Distances agree within 1e-5 relative (XLA:CPU contracts the
distance sums into FMAs, the port rounds every product), and so do the
interpolation weights and features, within 1e-5 of their scale."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepclr_tpu.ops import ball_query as jax_ball_query  # noqa: E402
from deepclr_tpu.ops.interpolate import (  # noqa: E402
    three_interpolate as jax_three_interpolate,
    three_interpolate_weights as jax_weights,
    three_nn as jax_three_nn,
)
from deepclr_tpu.ops.knn import knn_xla  # noqa: E402
from deepclr_tpu_torch import ops  # noqa: E402
from deepclr_tpu_torch.ops import ball_grouping as bq  # noqa: E402


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _case(name, seed=0):
    """(xyz, centres, mask, radius, nsample) for each behaviour the slots follow."""
    rng = np.random.default_rng(seed)
    b, n, p = 3, 600, 48
    xyz = rng.normal(size=(b, n, 3)).astype(np.float32) * 2.0
    centres = xyz[:, :p] + rng.normal(size=(b, p, 3)).astype(np.float32) * 0.2
    mask = None
    radius, nsample = 0.8, 16
    if name == "masked":
        mask = np.ones((b, n), bool)
        mask[0, n // 2:] = False   # a masked tail
        mask[2] = False            # an all-masked cloud: every ball empty
    elif name == "empty_ball":
        centres[:, :5] = 50.0      # far from every point
    elif name == "truncation":
        xyz = rng.uniform(0.0, 2.0, size=(b, n, 3)).astype(np.float32)  # ~60 points a ball
        centres = xyz[:, :p].copy()
        radius, nsample = 0.6, 8
    elif name == "nsample_above_hits":
        radius, nsample = 0.3, 64
    return xyz, centres, mask, radius, nsample


@pytest.mark.parametrize("name", ["plain", "masked", "empty_ball", "truncation", "nsample_above_hits"])
def test_ball_query_indices_equal_jax(name):
    xyz, centres, mask, radius, nsample = _case(name)
    ref = np.asarray(jax_ball_query(xyz, centres, radius, nsample, mask=mask))
    got = ops.ball_query(_t(xyz), _t(centres), radius, nsample, _t(mask))
    assert got.dtype == torch.int64 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    counts = (np.linalg.norm(xyz[:, None] - centres[:, :, None], axis=-1) < radius).sum(-1)
    if name == "truncation":
        assert counts.min() > nsample          # every ball truncated
    if name == "nsample_above_hits":
        assert 0 < counts.max() < nsample      # every ball padded with its first hit
    if name in ("masked", "empty_ball"):
        assert (ref == 0).all(-1).any()        # some ball empty: zeros


def test_ball_query_blocks_do_not_change_the_indices(monkeypatch):
    xyz, centres, mask, radius, nsample = _case("masked", seed=3)
    whole = ops.ball_query(_t(xyz), _t(centres), radius, nsample, _t(mask))
    monkeypatch.setattr(bq, "SCRATCH_BYTES", bq._BYTES_PER_ENTRY * 3 * 600 * 5)
    assert bq.block_centres(3, 48, 600) == 5  # ten blocks
    np.testing.assert_array_equal(ops.ball_query(_t(xyz), _t(centres), radius, nsample, _t(mask)).numpy(),
                                  whole.numpy())


@pytest.mark.parametrize("k", [3, 20, 40])
def test_knn_points_mask_matches_jax(k):
    """Masked points lie at float32's largest distance; a row with fewer
    valid points than k gets JAX's indices there too."""
    rng = np.random.default_rng(k)
    query = rng.normal(size=(2, 30, 3)).astype(np.float32)
    points = rng.normal(size=(2, 64, 3)).astype(np.float32)
    mask = np.ones((2, 64), bool)
    mask[0, ::3] = False
    mask[1, 5:] = False            # 5 valid points: fewer than k > 5
    ref_i, ref_d = knn_xla(query, points, k, points_mask=mask)
    got_i, got_d = ops.knn(_t(query), _t(points), k, _t(mask))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=1e-5, atol=1e-5)
    assert (got_d.numpy()[1, :, 5:] == np.finfo(np.float32).max).all()


def test_three_nn_and_interpolation_match_jax():
    rng = np.random.default_rng(7)
    unknown = rng.normal(size=(2, 200, 3)).astype(np.float32)
    known = rng.normal(size=(2, 40, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 40, 6)).astype(np.float32)
    mask = np.ones((2, 40), bool)
    mask[1, 30:] = False
    ref_d, ref_i = jax_three_nn(unknown, known, known_mask=mask)
    got_d, got_i = ops.three_nn(_t(unknown), _t(known), _t(mask))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=1e-5, atol=1e-5)
    ref_w = np.asarray(jax_weights(ref_d))
    got_w = ops.three_interpolate_weights(got_d)
    np.testing.assert_allclose(got_w.numpy(), ref_w, rtol=0, atol=1e-5)
    ref = np.asarray(jax_three_interpolate(feats, ref_i, ref_w))
    got = ops.three_interpolate(_t(feats), got_i, got_w).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
