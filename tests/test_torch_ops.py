"""The PyTorch port's ops (deepclr_tpu_torch.ops, geometry) against the JAX
package on the CPU: the same numpy inputs go through both.  Pallas kernels
run in interpret mode, as the JAX package's own tests run them."""
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import deepclr_tpu.ops.pallas.fps_kernel as jax_fps_kernel  # noqa: E402
from deepclr_tpu.geometry import LabelType as JaxLabelType  # noqa: E402
from deepclr_tpu.geometry import se3 as jax_se3  # noqa: E402
from deepclr_tpu.ops.fps import furthest_point_sample_xla  # noqa: E402
from deepclr_tpu.ops.fused_sa import multi_scale_bundle as jax_bundle  # noqa: E402
from deepclr_tpu.ops.grouping import gather_points as jax_gather, group_points as jax_group  # noqa: E402
from deepclr_tpu.ops.knn import knn_xla  # noqa: E402
from deepclr_tpu.ops.morton import morton_code as jax_morton_code, spatial_sort as jax_spatial_sort  # noqa: E402
from deepclr_tpu.ops.pairwise import pairwise_sqdist as jax_pairwise  # noqa: E402
from deepclr_tpu.ops.pallas.fused_sa_kernel import (  # noqa: E402
    ball_mlp_max_pallas,
    block_min_d2_pallas,
)
from deepclr_tpu_torch import ops  # noqa: E402
from deepclr_tpu_torch.geometry import LabelType, se3  # noqa: E402
from deepclr_tpu_torch.ops import fused_sa  # noqa: E402

BIG = 1e12


def _t(x):
    return torch.from_numpy(np.array(x))


def _clouds(b, n, seed, scale=(5.0, 5.0, 5.0)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n, 3)) * np.asarray(scale)).astype(np.float32)


def _masks(b, n, kind):
    if kind == "none":
        return None
    mask = np.ones((b, n), bool)
    mask[0, n * 3 // 4:] = False
    if kind == "empty_cloud":
        mask[-1] = False
    return mask


def _pallas_fps(xyz, npoint, mask):
    real_call = pl.pallas_call

    def interpret_call(*args, **kwargs):
        kwargs["interpret"] = True
        return real_call(*args, **kwargs)

    with mock.patch.object(jax_fps_kernel.pl, "pallas_call", interpret_call):
        return np.asarray(jax_fps_kernel.furthest_point_sample_pallas(xyz, npoint, mask=mask))


@pytest.mark.parametrize("mask_kind", ["none", "tail", "empty_cloud"])
@pytest.mark.parametrize("ties", [False, True])
def test_fps_bit_exact_with_jax_and_pallas(mask_kind, ties):
    xyz = _clouds(3, 512, seed=0)
    if ties:  # a coarse grid makes equal distances, so the tie rule decides
        xyz = np.round(xyz)
    mask = _masks(3, 512, mask_kind)
    ref = np.asarray(furthest_point_sample_xla(xyz, 64, mask=mask))
    np.testing.assert_array_equal(_pallas_fps(xyz, 64, mask), ref)
    got = ops.furthest_point_sample(_t(xyz), 64, None if mask is None else _t(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    if mask_kind == "empty_cloud":
        assert not got[-1].any()  # an all-masked cloud picks index 0


# XLA:CPU runs the interpret-mode kernel body as fma(dz,dz,fma(dx,dx,dy*dy));
# the TPU kernel and the port round every product.  On grid coordinates every
# product and sum is exact, so the two agree bit for bit; on random data they
# differ by at most one ulp.
@pytest.mark.parametrize("mask_kind", ["none", "tail"])
@pytest.mark.parametrize("grid", [True, False])
def test_block_min_d2_matches_pallas(mask_kind, grid):
    xyz = _clouds(2, 512, seed=1)
    centers = _clouds(2, 64, seed=2)
    if grid:
        xyz, centers = np.round(xyz * 8) / 8, np.round(centers * 8) / 8
    mask = _masks(2, 512, mask_kind)
    inval = np.zeros((2, 512), np.float32) if mask is None else (~mask).astype(np.float32) * BIG
    ref = np.asarray(block_min_d2_pallas(xyz, inval, centers, 128, interpret=True))
    pts4 = fused_sa._pack_points(_t(xyz), None if mask is None else _t(mask))
    got = fused_sa.block_min_d2(pts4, _t(centers)).numpy()
    if grid:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_array_max_ulp(got, ref, maxulp=1)


def test_block_min_d2_ragged_chunk():
    xyz = _clouds(2, 300, seed=3)
    centers = _clouds(2, 40, seed=4)
    got = fused_sa.block_min_d2(fused_sa._pack_points(_t(xyz), None), _t(centers)).numpy()
    assert got.shape == (2, 3, 40)
    d = xyz[:, :, None, :] - centers[:, None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    for c in range(3):
        np.testing.assert_array_equal(got[:, c], d2[:, c * 128:(c + 1) * 128].min(axis=1))


def test_cull_bitmap_keeps_every_in_radius_pair():
    xyz = _clouds(2, 1024, seed=5, scale=(3.0, 3.0, 0.5))
    xyz_t = ops.spatial_sort(_t(xyz))[0]
    centers = xyz_t[:, ::8]
    pts4 = fused_sa._pack_points(xyz_t, None)
    r2max = 1.0
    active = fused_sa.cull_bitmap(fused_sa.block_min_d2(pts4, centers), r2max).numpy()
    d = xyz_t.numpy()[:, :, None, :] - centers.numpy()[:, None, :, :]
    hit = (d * d).sum(-1) < r2max                                  # (B, N, P)
    bi, ji, pi = np.nonzero(hit)
    assert active[bi, ji // fused_sa.CHUNK, pi // fused_sa.TILE].all()
    assert 0 < active.mean() < 1  # the sorted cloud does cull


def _bundle_params(seed, in_dim=4, mlp=(16, 16, 32)):
    rng = np.random.default_rng(seed)
    sw, sb = [], []
    for _ in range(2):
        dims = [in_dim, *mlp]
        sw.append([(rng.normal(size=(dims[i], dims[i + 1])) * 0.3).astype(np.float32)
                   for i in range(len(mlp))])
        sb.append([(rng.normal(size=(dims[i + 1],)) * 0.1).astype(np.float32)
                   for i in range(len(mlp))])
    return sw, sb


def test_multi_scale_bundle_matches_jax():
    sw, sb = _bundle_params(6)
    jw, jb, jr = jax_bundle([[jnp.asarray(w) for w in ws] for ws in sw],
                            [[jnp.asarray(b) for b in bs] for bs in sb], (0.5, 1.0))
    tw, tb, tr = ops.multi_scale_bundle([[_t(w) for w in ws] for ws in sw],
                                        [[_t(b) for b in bs] for bs in sb], (0.5, 1.0))
    assert tr == jr
    for x, y in zip(tw + tb, list(jw) + list(jb)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# bf16: both sides round the same layer-1 activations to bf16, but the tail
# sums in another order, so a middle activation can land one bf16 ulp
# (2^-8 relative) apart; 2e-2 absolute bounds that at these weight scales.
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("mask_kind", ["tail", "empty_cloud"])
def test_fused_sa_plain_matches_pallas(dtype, atol, mask_kind):
    xyz = _clouds(2, 512, seed=7, scale=(1.5, 1.5, 1.5))
    feats = np.random.default_rng(8).normal(size=(2, 512, 1)).astype(np.float32)
    centers = xyz[:, :64].copy()
    mask = _masks(2, 512, mask_kind)
    sw, sb = _bundle_params(9)
    jw, jb, radius = jax_bundle([[jnp.asarray(w) for w in ws] for ws in sw],
                                [[jnp.asarray(b) for b in bs] for bs in sb], (0.5, 1.0))
    ref = np.asarray(ball_mlp_max_pallas(
        xyz, centers, tuple(jw), tuple(jb), radius, features=feats, mask=mask,
        compute_dtype=getattr(jnp, dtype), interpret=True))
    got = ops.ball_mlp_max(
        _t(xyz), _t(centers), [_t(np.asarray(w)) for w in jw], [_t(np.asarray(b)) for b in jb],
        radius, features=_t(feats), mask=_t(mask), compute_dtype=getattr(torch, dtype))
    assert got.shape == ref.shape == (2, 64, 64)
    assert (ref != 0).mean() > 0.3  # most balls hold points
    np.testing.assert_allclose(got.numpy(), ref, atol=atol, rtol=0)
    if mask_kind == "empty_cloud":
        assert not got[-1].any()  # every ball of an all-masked cloud is empty


def test_pairwise_and_grouping_match_jax():
    a, b = _clouds(2, 96, seed=10), _clouds(2, 80, seed=11)
    np.testing.assert_allclose(ops.pairwise_sqdist(_t(a), _t(b)).numpy(),
                               np.asarray(jax_pairwise(a, b)), rtol=1e-5, atol=1e-4)
    idx = np.random.default_rng(12).integers(0, 80, size=(2, 96, 5)).astype(np.int32)
    np.testing.assert_array_equal(ops.group_points(_t(b), _t(idx)).numpy(),
                                  np.asarray(jax_group(b, idx)))
    np.testing.assert_array_equal(ops.gather_points(_t(b), _t(idx[..., 0])).numpy(),
                                  np.asarray(jax_gather(b, idx[..., 0])))


def test_knn_matches_jax():
    q, p = _clouds(2, 128, seed=13), _clouds(2, 256, seed=14)
    p[:, 200:] = p[:, :56]  # duplicate points: equal distances go to the lowest index
    ref_idx, ref_d2 = knn_xla(q, p, 20)
    idx, d2 = ops.knn(_t(q), _t(p), 20)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(ref_d2), rtol=1e-5, atol=1e-4)


def test_morton_codes_and_stable_order_match_jax():
    rng = np.random.default_rng(15)
    xyz = _clouds(2, 4096, seed=15, scale=(30.0, 30.0, 2.0))
    xyz[:, 3000:3300] = xyz[:, 100:400]  # duplicate codes: the sort must be stable
    feats = rng.uniform(size=(2, 4096, 1)).astype(np.float32)
    mask = _masks(2, 4096, "tail")
    codes = ops.morton_code(_t(xyz), _t(mask)).numpy()
    np.testing.assert_array_equal(codes, np.asarray(jax_morton_code(xyz, mask)).astype(np.int64))
    assert len(np.unique(codes[1])) < 4096 - 200
    # the features are distinct per point, so they show the order of duplicate codes
    jx, jf, jm, _ = jax_spatial_sort(jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(mask))
    tx, tf, tm = ops.spatial_sort(_t(xyz), _t(feats), _t(mask))
    for got, ref in ((tx, jx), (tf, jf), (tm, jm)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _random_transforms(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[:, 0] = np.abs(q[:, 0])
    w, x, y, z = q.T
    r = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    m = np.tile(np.eye(4), (n, 1, 1))
    m[:, :3, :3] = r
    m[:, :3, 3] = rng.normal(size=(n, 3)) * 3.0
    return m.astype(np.float32)


@pytest.mark.parametrize("label", ["pose3d_euler", "pose3d_quat", "pose3d_dual_quat"])
def test_labels_match_jax(label):
    m = _random_transforms(6, seed=16)
    jl, tl = JaxLabelType.create(label), LabelType.create(label)
    assert (tl.dim, tl.bias) == (jl.dim, jl.bias)
    ref_label = np.asarray(jl.from_matrix(m))
    np.testing.assert_allclose(tl.to_matrix(_t(ref_label)).numpy(), np.asarray(jl.to_matrix(ref_label)),
                               atol=1e-5)


def test_dualquat_from_matrix_matches_jax():
    m = _random_transforms(6, seed=19)
    np.testing.assert_allclose(se3.dualquat_from_matrix(_t(m)).numpy(),
                               np.asarray(jax_se3.dualquat_from_matrix(m)), atol=1e-6)


def test_transform_points_matches_jax():
    m = _random_transforms(2, seed=17)
    pts = _clouds(2, 50, seed=18)
    np.testing.assert_allclose(se3.transform_points(_t(m), _t(pts)).numpy(),
                               np.asarray(jax_se3.transform_points(m, pts)), rtol=1e-6, atol=1e-5)
