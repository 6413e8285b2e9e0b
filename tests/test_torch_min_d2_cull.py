"""The culling pre-pass with its bitmap (``ops.fused_sa.block_min_d2_and_cull``,
one launch of csrc/min_d2.cu on the card) on the CPU: its plain path against
``cull_bitmap(_block_min_d2_plain(...))`` and against the JAX package's fold
of ``block_min_d2_pallas`` in interpret mode (``_prologue``'s "exact"
culling: the min over each 16-centre tile, times 0.99, minus 1e-3, below
r2max), on grid data where distances tie with the radius."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepclr_tpu.ops.pallas.fused_sa_kernel import block_min_d2_pallas  # noqa: E402
from deepclr_tpu_torch.ops import fused_sa  # noqa: E402
from deepclr_tpu_torch.ops.fused_sa import BIG, CHUNK, TILE  # noqa: E402


def _grid_case(seed, b=2, n=1024, p=64):
    """Points and centres on a 0.5 m grid (every d^2 a multiple of 0.25,
    every product and sum exact), the first cloud with a masked tail."""
    rng = np.random.default_rng(seed)
    xyz = (np.round(rng.normal(size=(b, n, 3)) * np.array([6.0, 6.0, 1.0]) * 2) / 2).astype(np.float32)
    xyz = xyz[:, np.argsort(xyz[0, :, 0], kind="stable")]  # sorted along x: chunks are local
    centers = xyz[:, ::n // p][:, :p].copy()
    mask = np.ones((b, n), bool)
    mask[0, n * 3 // 4:] = False
    return xyz, centers, mask


def _jax_fold(xyz, centers, mask, r2max):
    """deepclr_tpu/ops/pallas/fused_sa_kernel.py's "exact" culling fold, op
    by op (eager, so no multiply-add is contracted)."""
    b, n, _ = xyz.shape
    p = centers.shape[1]
    inval = (~mask).astype(np.float32) * BIG
    d2_sub = block_min_d2_pallas(xyz, inval, centers, CHUNK, interpret=True)
    lower = jnp.min(d2_sub.reshape(b, n // CHUNK, p // TILE, TILE), axis=3) * (1.0 - 1e-2) - 1e-3
    return np.asarray(d2_sub), np.asarray(lower), np.asarray(lower < r2max).astype(np.uint8)


def _fold(m):
    """One tile min folded as the kernel folds it: float32 products and sums."""
    return np.float32(np.float32(m) * np.float32(0.99)) - np.float32(1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pre_pass_bitmap_equals_cull_bitmap_and_jax_fold(seed):
    xyz, centers, mask = _grid_case(seed)
    pts4 = fused_sa._pack_points(torch.from_numpy(xyz), torch.from_numpy(mask))
    ref_d2 = fused_sa._block_min_d2_plain(pts4, torch.from_numpy(centers))
    tile_min = ref_d2.view(2, -1, 64 // TILE, TILE).amin(-1).numpy()
    # r2max a tile minimum: minima equal to the radius (kept: the margin
    # lowers them); r2max the fold of one: folded minima equal to r2max
    # (culled: the strict "<" and the fold's rounding decide them)
    at_d2 = float(np.median(tile_min[(tile_min > 0) & (tile_min < 20)]))
    for r2max in (at_d2, float(_fold(at_d2))):
        min_d2, active = fused_sa.block_min_d2_and_cull(pts4, torch.from_numpy(centers), r2max)
        assert active.dtype == torch.uint8 and active.shape == (2, 1024 // CHUNK, 64 // TILE)
        assert torch.equal(min_d2, ref_d2)
        assert torch.equal(active, fused_sa.cull_bitmap(ref_d2, r2max))
        d2_j, lower_j, active_j = _jax_fold(xyz, centers, mask, r2max)
        np.testing.assert_array_equal(min_d2.numpy(), d2_j)  # grid data: exact on both sides
        np.testing.assert_array_equal(active.numpy(), active_j)
        assert 0 < active.float().mean() < 1
        if r2max == at_d2:
            assert active.numpy()[tile_min == np.float32(r2max)].all()
        else:
            at_radius = lower_j == np.float32(r2max)
            assert at_radius.any() and not active.numpy()[at_radius].any()


@pytest.mark.parametrize("n,p", [(300, 40), (1000, 17)])
def test_pre_pass_ragged_shapes(n, p):
    """A ragged last chunk and a ragged last tile (its missing centres count
    as +inf), and an all-masked cloud whose blocks are all culled."""
    rng = np.random.default_rng(n)
    xyz = torch.from_numpy((rng.normal(size=(2, n, 3)) * 3).astype(np.float32))
    centers = xyz[:, ::n // p][:, :p].contiguous()
    mask = torch.ones(2, n, dtype=torch.bool)
    mask[1] = False
    pts4 = fused_sa._pack_points(xyz, mask)
    min_d2, active = fused_sa.block_min_d2_and_cull(pts4, centers, 1.0)
    assert active.shape == (2, -(-n // CHUNK), -(-p // TILE))
    assert torch.equal(min_d2, fused_sa.block_min_d2(pts4, centers))
    assert torch.equal(active, fused_sa.cull_bitmap(min_d2, 1.0))
    assert active[0].any() and not active[1].any()
