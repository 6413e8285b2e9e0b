"""The gathers' backward in the PyTorch port (``ops/grouping.py``: an autograd
Function whose backward sums each source row's cotangents in ascending
order, ``gather_points_grad``; on the card ``csrc/gather.cu``) against
``jax.grad`` of the JAX package's gathers, on the CPU, on the same seeded
inputs: MotionEmbedding's shape (k = 20 neighbours of P template points
among N source rows), with duplicate indices (a few rows take most of the
neighbours) and masked rows (their output multiplied by 0 before the
loss), float32, within 1e-6 of the gradient's scale.  B5's backward
scatter (``ops/fused_sa.py::_winner_grads``) takes the same sum."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepclr_tpu.ops.grouping import gather_points as jax_gather, group_points as jax_group  # noqa: E402
from deepclr_tpu_torch import ops  # noqa: E402
from deepclr_tpu_torch.ops import grouping  # noqa: E402

TOL = 1e-6


def _inputs(seed, b=2, n=64, p=48, k=20, c=16, hot=4):
    """Points, neighbour indices (half of them among ``hot`` rows, so rows
    repeat within and across neighbourhoods), output weights and a row mask."""
    rng = np.random.default_rng(seed)
    points = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, size=(b, p, k))
    hot_rows = rng.integers(0, hot, size=(b, p, k))
    idx = np.where(rng.uniform(size=(b, p, k)) < 0.5, hot_rows, idx).astype(np.int32)
    w = rng.normal(size=(b, p, k, c)).astype(np.float32)
    mask = rng.uniform(size=(b, p)) < 0.7
    return points, idx, w, mask


def _check(got, want):
    scale = max(1e-6, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("seed", [0, 1])
def test_group_points_gradient_matches_jax(seed):
    points, idx, w, mask = _inputs(seed)
    m = mask[..., None, None].astype(np.float32)

    def jax_loss(x):
        return jnp.sum(jax_group(x, jnp.asarray(idx)) * w * m)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(points)))
    x = torch.from_numpy(points).requires_grad_()
    (ops.group_points(x, torch.from_numpy(idx)) * torch.from_numpy(w) * torch.from_numpy(m)).sum().backward()
    _check(x.grad.numpy(), want)
    # every masked row's cotangent is zero, yet its rows are listed
    assert (idx[~mask] < 4).any()


def test_gather_points_gradient_matches_jax():
    points, idx, w, _ = _inputs(2)
    flat, wf = idx[:, :, 0], w[:, :, 0]
    want = np.asarray(jax.grad(lambda x: jnp.sum(jax_gather(x, jnp.asarray(flat)) * wf))(jnp.asarray(points)))
    x = torch.from_numpy(points).requires_grad_()
    (ops.gather_points(x, torch.from_numpy(flat)) * torch.from_numpy(wf)).sum().backward()
    _check(x.grad.numpy(), want)


def test_gather_points_grad_sums_in_ascending_order():
    """The plain twin (the CPU path and the card kernel's yardstick) adds
    each row's cotangents in ascending output order: a float32 sum taken
    left to right, with values that expose the order."""
    g = np.array([[[1e8], [1.0], [-1e8], [1.0], [3.0]]], np.float32)
    idx = np.array([[0, 0, 0, 0, 1]])
    got = ops.gather_points_grad(torch.from_numpy(g), torch.from_numpy(idx), 3).numpy()
    want = np.float32(np.float32(np.float32(np.float32(1e8) + np.float32(1.0)) + np.float32(-1e8)) + np.float32(1.0))
    assert got[0, 0, 0] == want and got[0, 1, 0] == 3.0 and got[0, 2, 0] == 0.0
    assert got.dtype == np.float32


def test_no_gradient_takes_the_plain_gather():
    """Without a gradient (inference) the forward is torch.gather alone, no
    autograd node; with one, the Function's node."""
    points, idx, _, _ = _inputs(3)
    x = torch.from_numpy(points)
    out = ops.group_points(x, torch.from_numpy(idx))
    assert out.grad_fn is None
    out = ops.group_points(x.requires_grad_(), torch.from_numpy(idx))
    assert type(out.grad_fn.next_functions[0][0]).__name__.startswith("_GatherBackward")
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jax_group(jnp.asarray(points), jnp.asarray(idx))))


def test_gather_points_grad_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        grouping.gather_points_grad(torch.zeros(2, 5, 3), torch.zeros(2, 4, dtype=torch.long), 8)


# The card's run index (csrc/gather.cu, launch 1) and its twin: segments of
# segment_length(n) consecutive m, each sorted stably by index.  Cases:
# uniform over several segments; one row named by every m of cloud 0 (a run
# crossing every segment); more than 32 segments of 1024 (the sum reads 32
# segments a pass); B5-like (more rows than m, most unnamed); no index.
_INDEX_CASES = {
    "uniform": (2, 5000, 64, "uniform"),
    "one_row": (2, 5000, 64, "one_row"),
    "34_segments": (1, 33 * 1024 + 5, 8192, "uniform"),
    "b5_like": (2, 3000, 4096, "uniform"),
    "unnamed": (2, 0, 50, "uniform"),
}


def _index(b, m, n, kind, seed=21):
    idx = torch.from_numpy(np.random.default_rng(seed).integers(0, n, size=(b, m)))
    if kind == "one_row":
        idx[0] = n // 3
    return idx


@pytest.mark.parametrize("case", list(_INDEX_CASES))
def test_run_index_twin_lists_each_row_as_a_stable_sort_does(case):
    """Each row's run, read from the run index segment by segment, is the
    row's span of a global stable sort of the index (torch.sort(stable=True)
    and searchsorted), so the m come in ascending order."""
    b, m, n, kind = _INDEX_CASES[case]
    idx = _index(b, m, n, kind)
    perm, offsets = grouping.gather_bwd_index(idx, n)
    lseg = grouping.segment_length(n)
    assert perm.dtype == torch.int32 and offsets.dtype == torch.int16
    assert perm.shape == (b, m) and offsets.shape == (b, -(-m // lseg), n + 1)
    order = torch.sort(idx, dim=1, stable=True)
    bounds = torch.searchsorted(order.values, torch.arange(n + 1).expand(b, -1).contiguous())
    for bb in range(b):
        for j in range(n):
            run = torch.cat([perm[bb, s * lseg + int(offsets[bb, s, j]):s * lseg + int(offsets[bb, s, j + 1])]
                             for s in range(offsets.shape[1])] or [torch.zeros(0, dtype=torch.int32)])
            want = order.indices[bb, int(bounds[bb, j]):int(bounds[bb, j + 1])]
            assert torch.equal(run.long(), want), (bb, j)


@pytest.mark.parametrize("case", list(_INDEX_CASES))
def test_sum_over_the_run_index_equals_the_sequential_scatter_add(case):
    """The sum launch's twin, adding each row's run in the run index's
    order, equals the CPU's scatter_add_ bit for bit (the card gate's
    reference), narrow channels (C = 3) and float4 ones (C = 8)."""
    b, m, n, kind = _INDEX_CASES[case]
    idx = _index(b, m, n, kind)
    perm, offsets = grouping.gather_bwd_index(idx, n)
    for c in (3, 8):
        g = torch.from_numpy(np.random.default_rng(22).normal(size=(b, m, c)).astype(np.float32)) * 1e3
        got = grouping.gather_bwd_sum(g, perm, offsets, n)
        assert torch.equal(got.view(torch.int32), ops.gather_points_grad(g, idx, n).view(torch.int32))


def test_run_index_puts_indices_outside_the_rows_last():
    """An index outside [0, n) goes to bucket n, after every row: summed
    into no row."""
    idx = torch.tensor([[3, -1, 0, 7, 3, 9]])
    perm, offsets = grouping.gather_bwd_index(idx, 4)
    assert offsets[0, 0].tolist() == [0, 1, 1, 1, 3]
    assert perm[0].tolist() == [2, 0, 4, 1, 3, 5]
    g = torch.arange(6, dtype=torch.float32).view(1, 6, 1)
    assert grouping.gather_bwd_sum(g, perm, offsets, 4)[0, :, 0].tolist() == [2.0, 0.0, 0.0, 4.0]


@pytest.mark.parametrize("n", [1, 50, 1024, 4097, 16384, grouping.MAX_ROWS])
def test_segment_length_fits_a_warp_and_keeps_the_offsets_linear(n):
    """A power of two from 128 to 16384; a warp's shared arrays (int32 keys,
    uint16 ranks and counts) within the H100's 227 KB a block; the offsets,
    S (n + 1) entries for M indices, within 9 M + 2 (n + 1)."""
    lseg = grouping.segment_length(n)
    assert lseg & (lseg - 1) == 0 and 128 <= lseg <= 16384
    assert 6 * lseg + 2 * (n + 1) <= 232448
    for m in (1, 20480, 65536, 10 ** 6):
        assert -(-m // lseg) * (n + 1) <= 9 * m + 2 * (n + 1)
