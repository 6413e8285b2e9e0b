"""The cluster FPS kernel's partitioned argmax (csrc/fps.cu), emulated on
the CPU, against the port's plain FPS and the JAX package's
``furthest_point_sample_xla``; and the rule that picks the cluster size.

On the card, each of a cloud's C CTAs owns a contiguous range of ceil(N/C)
indices; every step each range offers (its largest running distance, the
lowest index holding it), and the candidates merge as (larger distance,
then smaller index), compared through the kernel's order-preserving 32-bit
map of the distance.  The emulation pins that cross-CTA tie rule where no
card is present."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepclr_tpu.ops.fps import furthest_point_sample_xla  # noqa: E402
from deepclr_tpu_torch.ops import fps  # noqa: E402


def _ordered(d: torch.Tensor) -> torch.Tensor:
    """csrc/fps.cu's ordered(): float32 -> uint32 (held in int64) with the
    float order."""
    u = d.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)


def _merge(keys: torch.Tensor, c: int) -> torch.Tensor:
    """The winner of C contiguous index ranges: each range's (max key,
    lowest index), merged as (larger key, smaller index)."""
    b, n = keys.shape
    per = -(-n // c)
    best_k = torch.full((b,), -1, dtype=torch.int64)
    best_i = torch.full((b,), n, dtype=torch.int64)
    for r in range(c):
        lo, hi = r * per, min(n, (r + 1) * per)
        if lo >= hi:  # a CTA past the cloud offers nothing that can win
            continue
        i_r = lo + torch.argmax(keys[:, lo:hi], dim=1)  # the first max: the range's lowest index
        k_r = keys.gather(1, i_r[:, None])[:, 0]
        take = (k_r > best_k) | ((k_r == best_k) & (i_r < best_i))
        best_k, best_i = torch.where(take, k_r, best_k), torch.where(take, i_r, best_i)
    return best_i


def _fps_partitioned(xyz: torch.Tensor, npoint: int, mask: torch.Tensor, c: int) -> torch.Tensor:
    b = xyz.shape[0]
    rows = torch.arange(b)
    dists = torch.where(mask, 1e10, -1.0).to(torch.float32)
    idx = torch.zeros((b, npoint), dtype=torch.int64)
    idx[:, 0] = _merge(_ordered(mask.to(torch.float32)), c)  # key 1 valid, 0 invalid
    x, y, z = xyz.unbind(-1)
    for i in range(1, npoint):
        ct = xyz[rows, idx[:, i - 1]]
        dx, dy, dz = x - ct[:, 0:1], y - ct[:, 1:2], z - ct[:, 2:3]
        d = dx * dx + dy * dy
        d = d + dz * dz
        dists = torch.minimum(dists, torch.where(mask, d, -1.0))
        idx[:, i] = _merge(_ordered(dists), c)
    return idx.to(torch.int32)


def _clouds(grid, n=500, seed=0):
    """3 clouds of n points: the first with a masked tail, the last all
    masked; on a coarse grid every distance ties with many others."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(3, n, 3)) * np.array([6.0, 6.0, 1.0])
    if grid:
        xyz = np.round(xyz)
    mask = np.ones((3, n), bool)
    mask[0, n * 5 // 8:] = False
    mask[2] = False
    return xyz.astype(np.float32), mask


def test_ordered_map_keeps_the_float_order():
    d = torch.tensor([-np.inf, -1.0, -0.0, 0.0, 1e-30, 1.0, 2.5, 1e10, np.inf], dtype=torch.float32)
    k = _ordered(d)
    assert torch.all(k[1:] >= k[:-1]) and k[2] < k[3] and k[0] > 0


@pytest.mark.parametrize("c", fps.CLUSTER_SIZES)
@pytest.mark.parametrize("grid", [True, False])
def test_partitioned_argmax_equals_plain_and_jax(c, grid):
    """N = 500 leaves ragged ranges at every C > 1 (and at C = 16 one range
    of 20 points); bit for bit with _fps_plain, and with the JAX reference on
    the grid clouds (where XLA:CPU's contracted distances are exact too)."""
    xyz, mask = _clouds(grid)
    got = _fps_partitioned(torch.from_numpy(xyz), 64, torch.from_numpy(mask), c)
    plain = fps._fps_plain(torch.from_numpy(xyz), 64, torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    if grid:
        np.testing.assert_array_equal(got.numpy(), np.asarray(furthest_point_sample_xla(xyz, 64, mask=mask)))
    assert not got[2].any()  # an all-masked cloud picks index 0


SMS = 132  # a card of 132 SMs


def _one_cta_an_sm(c):
    """A stand-in for the card's occupancy answer: one CTA an SM."""
    return SMS // c


@pytest.mark.parametrize("b,expected", [(1, 16), (10, 8), (32, 4)])
def test_cluster_size_rule_without_a_card(b, expected):
    """A power of two <= 16, B * C within the capacity, and the largest
    such."""
    c = fps.cluster_size(b, 16384, _one_cta_an_sm)
    assert c == expected and c in fps.CLUSTER_SIZES and c & (c - 1) == 0
    assert b * c <= SMS and (c == 16 or 2 * b * c > SMS)


def test_cluster_size_rule_takes_the_cards_answer_and_the_cloud_size():
    # CTAs that share an SM: the card holds 42 clusters of 16
    assert fps.cluster_size(32, 16384, lambda c: 42 * 16 // c) == 16
    assert fps.cluster_size(32, 16384, lambda c: 32 if c <= 2 else 31) == 2
    assert fps.cluster_size(1, 2000, lambda c: 0) == 1
    # a cloud too large for one CTA forces the smallest cluster that holds it
    assert fps.cluster_size(64, 40000, _one_cta_an_sm) == 4 == fps.cluster_size(1, 40000, lambda c: 0)
    with pytest.raises(ValueError, match="exceeds"):
        fps.cluster_size(1, fps.FPS_MAX_POINTS + 1, _one_cta_an_sm)


def test_cluster_argument_is_checked_and_does_not_change_the_cpu_result():
    xyz, mask = _clouds(True)
    xyz, mask = torch.from_numpy(xyz), torch.from_numpy(mask)
    ref = fps.furthest_point_sample(xyz, 32, mask)
    assert torch.equal(fps.furthest_point_sample(xyz, 32, mask, cluster=4), ref)
    with pytest.raises(ValueError, match="cluster size"):
        fps.furthest_point_sample(xyz, 32, mask, cluster=3)
    with pytest.raises(ValueError, match="exceeds"):
        fps.furthest_point_sample(torch.zeros(1, fps.MAX_POINTS_PER_CTA + 1, 3), 4, cluster=1)
