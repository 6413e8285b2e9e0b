"""The set-abstraction backward's block schedule (csrc/fused_sa.cu,
``fused_sa_bwd_kernel`` and ``fused_sa_bwd_finish_kernel``), emulated on the
CPU in float32, against the port's plain twin and the JAX package's Pallas
backward (``ball_mlp_max_bwd_pallas``) in interpret mode, and shown to give
the same bits whatever order its blocks and warps finish in.

On the card one block of four warps takes one (cloud, 16-centre tile).  For
each kept chunk it lists the chunk's in-radius pairs q = t + 16 i in
ascending q (per (pass, warp) counts, a scan, ballot ranks), and takes them
in rounds of 32, each round cut into four contiguous warp runs.  Every sum
has a fixed order:

* da: a warp sums consecutive pairs of one point in a float32 register and
  adds the sum, rounded to multiples of 2^-S, into an int64 entry
  (``fused_sa.da_scale`` gives S); a sum that is not finite sets the
  (point, lane) bit of a flag word instead; the finishing launch converts
  the integers to float32 and writes NaN where a bit is set.  Integer
  addition and OR are associative, so the order of the atomics does not
  matter;
* dbc and db: one row a warp, summed in warp order at the end of the block;
* dW and db across blocks: each block stores its partial sums in its own
  workspace row (dW3 and dW2 summed pair by pair in list order); the
  finishing launch sums the rows per column in 8 segments (rows s, s + 8,
  ...) and then the segments, in order.

The emulation takes every pair's activations from the plain twin's calls
(``_chunk_pairs`` and ``_pair_mlp``) and back-propagates them with the
twin's arithmetic, so what it tests is the schedule: which pairs each
block lists and in which order, and that each reduction order is a function
of the inputs alone.  Against the twin and the Pallas kernel, float32,
within 1e-5 of each result's scale (the sums run in other orders)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepclr_tpu.ops.pallas.fused_sa_kernel import ball_mlp_max_bwd_pallas, ball_mlp_max_pallas  # noqa: E402
from deepclr_tpu_torch.ops import fused_sa  # noqa: E402
from deepclr_tpu_torch.ops.fused_sa import CHUNK, TILE  # noqa: E402

from .test_torch_fused_sa_schedule import _inputs, _port  # noqa: E402

WARPS = 4
ROUND = 32          # csrc/fused_sa.cu kRound
PASS = 128          # list_pairs: pass k tests q = k * 128 + tid
SEGMENTS = 8        # fused_sa_bwd_finish_kernel: row segments a column
TOL = 1e-5


def _list(op, bb, p0, c):
    """Chunk c's in-radius pairs with the tile's centres in the block's
    order -> (q, j, t): per (pass, warp) hit counts scanned in that order,
    each hit at its offset plus its rank among its warp's hits in the pass."""
    n, p = op.pts4.shape[1], op.centers.shape[1]
    q = np.arange(TILE * CHUNK)
    t, i = q % TILE, q // TILE
    j = c * CHUNK + i
    pt = op.pts4[bb, np.minimum(j, n - 1)]
    ct = op.centers[bb, np.minimum(p0 + t, p - 1)]
    d2 = fused_sa._sq_dist(pt[:, 0], pt[:, 1], pt[:, 2], ct[:, 0], ct[:, 1], ct[:, 2]).numpy()
    hit = (j < n) & (pt[:, 3] == 0).numpy() & (p0 + t < p) & (d2 < op.r2max)
    passes = hit.reshape(-1, WARPS, 32)                      # [pass, warp, lane]
    counts = passes.sum(-1).reshape(-1)                      # (pass, warp) order
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).reshape(passes.shape[:2])
    slots = np.full(int(hit.sum()), -1)
    for k, w, lane in zip(*np.nonzero(passes)):
        slots[offsets[k, w] + passes[k, w, :lane].sum()] = k * PASS + 32 * w + lane
    assert (slots >= 0).all()
    return slots, j[slots], t[slots]


def _activations(op, tail_w):
    """{(cloud, centre, point): its three float32 activation rows}, from the
    forward twin's calls chunk by chunk: the equality select needs the
    forward's exact bits, and a matmul over another batch of pairs may
    round differently."""
    acts = {}
    for s in range(0, op.pts4.shape[1], CHUNK):
        bi, pi, j, _ = fused_sa._chunk_pairs(op, s)
        if bi.numel():
            hs = fused_sa._pair_mlp(op, tail_w, bi, pi, j)
            for row, key in enumerate(zip(bi.tolist(), pi.tolist(), j.tolist())):
                acts[key] = tuple(h[row] for h in hs)
    return acts


def _backprop(op, tail_w, acts, out, g, bb, p0, j, t):
    """The twin's per-pair backward for the listed pairs: the rounded layer
    inputs and deltas the kernel stages, db3's and db2's terms, d0 and
    whether any column was selected (float32 numpy)."""
    cd = op.compute_dtype
    pi, ji = torch.from_numpy(p0 + t).long(), torch.from_numpy(j).long()
    h1, h2, h3 = (torch.stack(h) for h in zip(*(acts[(bb, int(pp), int(jj))] for pp, jj in zip(p0 + t, j))))
    pt, ct = op.pts4[bb, ji], op.centers[bb, pi]
    d2 = fused_sa._sq_dist(pt[:, 0], pt[:, 1], pt[:, 2], ct[:, 0], ct[:, 1], ct[:, 2])
    sel = (d2[:, None] < op.r2) & (h3 > 0) & (h3 == out[bb, pi])
    g3 = torch.where(sel, g[bb, pi], 0.0)
    d3 = g3.to(cd).float()
    dl2 = torch.where(h2 > 0, torch.matmul(d3, tail_w[1].t()), 0.0)  # relu' selects, as the kernel does
    d2r = dl2.to(cd).float()
    d0 = torch.where(h1 > 0, torch.matmul(d2r, tail_w[0].t()), 0.0)
    f = lambda x: x.numpy().astype(np.float32)  # noqa: E731
    return dict(h1=f(h1.to(cd).float()), h2=f(h2.to(cd).float()), d3=f(d3), d2=f(d2r), g3=f(g3), dl2=f(dl2),
                d0=f(d0), live=(g3 != 0).any(-1).numpy())


def _block(op, active, tail_w, acts, out, g, bb, tile, scale):
    """One block -> (its workspace row, its dbc rows, its da flushes: (j,
    int64 row, the row's non-finite lanes) in the block's order)."""
    n = op.pts4.shape[1]
    h1w, h2w, h3w = fused_sa.KERNEL_WIDTHS
    p0 = tile * TILE
    dw3, dw2 = np.zeros((h2w, h3w), np.float32), np.zeros((h1w, h2w), np.float32)
    dbc = np.zeros((WARPS, TILE, h1w), np.float32)
    db3, db2 = np.zeros((WARPS, h3w), np.float32), np.zeros((WARPS, h2w), np.float32)
    flushes = []

    def flush(j, v):
        bad = ~np.isfinite(v)
        flushes.append((j, np.rint(np.where(bad, 0.0, v.astype(np.float64)) * scale).astype(np.int64), bad))

    for c in range(-(-n // CHUNK)):
        if not active[bb, c, tile]:
            continue
        _, j, t = _list(op, bb, p0, c)
        if not len(j):
            continue
        v = _backprop(op, tail_w, acts, out, g, bb, p0, j, t)
        for base in range(0, len(j), ROUND):
            live = min(ROUND, len(j) - base)
            per = -(-live // WARPS)
            for w in range(WARPS):
                cur, da_sum = -1, np.zeros(h1w, np.float32)
                for r in range(base + w * per, base + min((w + 1) * per, live)):
                    db3[w] = db3[w] + v["g3"][r]
                    if not v["live"][r]:
                        continue
                    db2[w] = db2[w] + v["dl2"][r]
                    if j[r] != cur:
                        if cur >= 0:
                            flush(cur, da_sum)
                        cur, da_sum = j[r], np.zeros(h1w, np.float32)
                    da_sum = da_sum + v["d0"][r]
                    dbc[w, t[r]] = dbc[w, t[r]] + v["d0"][r]
                if cur >= 0:
                    flush(cur, da_sum)
            for r in range(base, base + live):  # the block's dW sums: pair by pair, in list order
                dw3 = dw3 + np.outer(v["h2"][r], v["d3"][r])
                dw2 = dw2 + np.outer(v["h1"][r], v["d2"][r])
    in_warp_order = lambda x: x[0] + x[1] + x[2] + x[3]  # noqa: E731  (left to right)
    row = np.concatenate([dw3.ravel(), dw2.ravel(), in_warp_order(db3), in_warp_order(db2)])
    return row, in_warp_order(dbc), flushes


def _blocks(op, active, out, g):
    """Every block of the kernel -> (workspace rows, dbc, each block's da
    flushes, S)."""
    b, n, h1w = op.a.shape
    p = op.centers.shape[1]
    ntiles = -(-p // TILE)
    tail_w = fused_sa._rounded_tail(op)
    acts = _activations(op, tail_w)
    exp = int(fused_sa.da_scale(*tail_w, g, p)[0])
    blocks = [(bb, tile) for bb in range(b) for tile in range(ntiles)]
    rows = np.zeros((len(blocks), fused_sa.PART_WIDTH), np.float32)
    dbc = np.zeros((b, ntiles * TILE, h1w), np.float32)
    events = []
    for k, (bb, tile) in enumerate(blocks):
        rows[k], dbc[bb, tile * TILE:(tile + 1) * TILE], fl = _block(op, active, tail_w, acts, out, g, bb, tile,
                                                                     2.0 ** exp)
        events.append([(bb, j, x, bad) for j, x, bad in fl])
    return rows, dbc[:, :p], events, exp


def _emulate(op, active, out, g, blocks=None, order=None, float_atomics=False):
    """The kernel and its finishing launch -> (da, dbc, [dW2, dW3], [db2,
    db3]).  ``order`` permutes the blocks (and the da flushes within each)
    in the order they "finish"; ``float_atomics`` adds the da flushes as
    float32 in that order instead (the previous design)."""
    rows, dbc, events, exp = blocks or _blocks(op, active, out, g)
    b, n, h1w = op.a.shape
    if order is not None:
        rng = np.random.default_rng(order)
        events = [events[k] for k in rng.permutation(len(events))]
        events = [[e[m] for m in rng.permutation(len(e))] for e in events]
    if float_atomics:
        da = np.zeros((b, n, h1w), np.float32)
        for bb, j, x, _ in (e for blk in events for e in blk):
            da[bb, j] = da[bb, j] + np.ldexp(x.astype(np.float64), -exp).astype(np.float32)
    else:
        fixed = np.zeros((b, n, h1w), np.int64)
        flags = np.zeros((b, n), np.uint32)
        for bb, j, x, bad in (e for blk in events for e in blk):
            fixed[bb, j] += x
            flags[bb, j] |= np.uint32((bad.astype(np.uint64) << np.arange(h1w, dtype=np.uint64)).sum())
        flagged = ((flags[..., None] >> np.arange(h1w, dtype=np.uint32)) & 1).astype(bool)
        da = np.where(flagged, np.float32(np.nan), np.ldexp(fixed.astype(np.float32), -exp))
    segs = [np.zeros(fused_sa.PART_WIDTH, np.float32) for _ in range(SEGMENTS)]
    for r in range(len(rows)):
        segs[r % SEGMENTS] = segs[r % SEGMENTS] + rows[r]
    total = segs[0]
    for seg in segs[1:]:
        total = total + seg
    dw3, dw2, db3, db2 = np.split(total, np.cumsum(fused_sa.PART_SPLIT)[:-1])
    h1w, h2w, h3w = fused_sa.KERNEL_WIDTHS
    return da, dbc, [dw2.reshape(h1w, h2w), dw3.reshape(h2w, h3w)], [db2, db3]


def _flat(res):
    return [np.asarray(res[0]), np.asarray(res[1]), *map(np.asarray, res[2]), *map(np.asarray, res[3])]


def _close(got, want):
    for name, x, y in zip(("da", "dbc", "dw2", "dw3", "db2", "db3"), _flat(got), _flat(want)):
        assert x.shape == y.shape, name
        scale = max(1e-3, float(np.abs(y).max()))
        np.testing.assert_allclose(x, y, rtol=0, atol=TOL * scale, err_msg=name)


def _bits(x):
    return x.view(np.int32 if x.dtype == np.float32 else x.dtype).tobytes()


@pytest.fixture(scope="module")
def case():
    """Three 1024-point clouds (a masked tail, an all-masked cloud) with 128
    centres, the forward's own output and a seeded cotangent; float32."""
    inputs = _inputs(7, n=1024, p=128)
    op, active = _port(inputs, torch.float32)
    out = fused_sa._fused_sa_plain(op)
    g = torch.from_numpy(np.random.default_rng(8).normal(size=tuple(out.shape)).astype(np.float32))
    return inputs, op, active, out, g


def test_list_holds_each_chunk_in_ascending_q(case):
    """The ordered list equals the chunk's hits sorted by q = t + 16 i, so
    a point's centres stay together (point-major)."""
    _, op, active, _, _ = case
    seen = 0
    for tile in range(active.shape[2]):
        for c in np.nonzero(active[0, :, tile].numpy())[0]:
            q, j, t = _list(op, 0, tile * TILE, int(c))
            assert (np.diff(q) > 0).all()
            seen += len(q)
    assert seen > 0


def test_schedule_equals_plain_twin(case):
    _, op, active, out, g = case
    got = _emulate(op, active, out, g)
    want = fused_sa._fused_sa_bwd_plain(op, out, g)
    _close(got, [want[0].numpy(), want[1].numpy(), [w.numpy() for w in want[2]], [x.numpy() for x in want[3]]])
    assert np.abs(got[2][1]).max() > 0 and not got[0][2].any()  # winners selected; nothing in the masked cloud


def test_schedule_matches_pallas(case):
    inputs, op, active, out, g = case
    xyz, feats, mask, centers, w, bias, radius = inputs
    jw, jb = tuple(map(jnp.asarray, w)), tuple(map(jnp.asarray, bias))
    out_j = ball_mlp_max_pallas(xyz, centers, jw, jb, radius, features=feats, mask=mask,
                                compute_dtype=jnp.float32, interpret=True)
    ref = ball_mlp_max_bwd_pallas(xyz, centers, jw, jb, radius, g.numpy(), out_j, features=feats, mask=mask,
                                  compute_dtype=jnp.float32, interpret=True)
    _close(_emulate(op, active, out, g), [ref[0], ref[1], list(ref[2]), list(ref[3])])


def test_finish_order_leaves_every_output_bit_equal(case):
    """Blocks and their warps' da flushes applied in three shuffled orders:
    every output equal bit for bit.  Float atomics in the same orders (the
    previous design) do change da's bits, so the check can see an order."""
    _, op, active, out, g = case
    blocks = _blocks(op, active, out, g)
    base = _flat(_emulate(op, active, out, g, blocks))
    for order in (1, 2, 3):
        for x, y in zip(_flat(_emulate(op, active, out, g, blocks, order=order)), base):
            assert _bits(x) == _bits(y)
    floats = [_emulate(op, active, out, g, blocks, order=order, float_atomics=True)[0] for order in (1, 2, 3)]
    assert any(a.tobytes() != floats[0].tobytes() for a in floats[1:])


# one NaN and one inf in g at entries some in-radius pair selects (the
# equality select and relu' pass them), each alone
@pytest.mark.parametrize("value", [np.nan, np.inf])
def test_non_finite_cotangent_flags_exactly_the_twins_entries(case, value):
    """A non-finite cotangent never reaches the fixed-point integers: the
    flushes that carry it set their (point, lane) flag bits and the
    finishing step writes NaN there.  The emulated da is non-finite exactly
    where the plain twin's is, its other entries agree with the twin's
    within 1e-5 of their scale, and every output keeps its bits under
    three finish orders, NaN positions included.  S is the finite part's,
    as without the non-finite entry; the scale flags the cotangent."""
    _, op, active, out, g = case
    tail_w = fused_sa._rounded_tail(op)
    p = out.shape[1]
    bb, t = 1, 9
    g = g.clone()
    g[bb, t, 5] = value
    state = fused_sa.da_scale(*tail_w, g, p)
    assert int(state[1]) == fused_sa.DA_G_NONFINITE
    assert int(state[0]) == int(fused_sa.da_scale(*tail_w, torch.where(torch.isfinite(g), g, 0.0), p)[0])
    blocks = _blocks(op, active, out, g)
    got = _flat(_emulate(op, active, out, g, blocks))
    twin = fused_sa._fused_sa_bwd_plain(op, out, g)
    want = [twin[0].numpy(), twin[1].numpy(), *[w.numpy() for w in twin[2]], *[x.numpy() for x in twin[3]]]
    bad, bad_twin = ~np.isfinite(got[0]), ~np.isfinite(want[0])
    assert bad.any() and np.array_equal(bad, bad_twin)
    scale = max(1e-3, float(np.abs(want[0][~bad_twin]).max()))
    np.testing.assert_allclose(got[0][~bad], want[0][~bad], rtol=0, atol=TOL * scale)
    for order in (1, 2):
        for x, y in zip(_flat(_emulate(op, active, out, g, blocks, order=order)), got):
            assert _bits(x) == _bits(y)
