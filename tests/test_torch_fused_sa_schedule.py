"""The fused set-abstraction forward's block schedule (csrc/fused_sa.cu,
``fused_sa_kernel``), emulated on the CPU, against the port's plain twins
and the JAX package's Pallas kernels in interpret mode.

On the card one block of four warps takes one (cloud, 16-centre tile).  It
compacts its tile's kept chunks (the culling bitmap) 128 at a time with
warp ballots.  For each kept chunk, thread i tests point i against the
tile's centres, and the hits are appended to the block's pair list
centre-major ((centre, warp) counts, a scan, then ballot ranks), each with
its global point index and d^2, so the list accumulates over chunks.  A
round runs once the list could not take another chunk's 2048 pairs, and at
the end: the list's pairs go in four contiguous runs, one a warp, and a
warp keeps each column's running max in registers while the centre stays
the same, flushing it into the block's shared max when the centre changes.
The max word is the value's int bits (B2) or (bits << 32) | ~j (B5), so
ties go to the lowest point index.

The emulation takes every pair's MLP values from the same calls the plain
twins make (``_chunk_pairs`` and ``_pair_mlp``, chunk by chunk), so what it
tests is the schedule: which pairs reach the list and in which order, and
that the maxima and the tie rule survive runs, rounds and flushes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepclr_tpu.ops.fused_sa import multi_scale_bundle as jax_bundle  # noqa: E402
from deepclr_tpu.ops.pallas.fused_sa_kernel import (  # noqa: E402
    ball_mlp_max_pallas,
    ball_mlp_max_pallas_argmax,
)
from deepclr_tpu_torch import ops  # noqa: E402
from deepclr_tpu_torch.ops import fused_sa  # noqa: E402
from deepclr_tpu_torch.ops.fused_sa import CHUNK, TILE  # noqa: E402

WARPS = 4
WINDOW = 128                    # bitmap bytes a block reads at once, one a thread
LIST_CAP = 3072                 # csrc/fused_sa.cu kListCap
PAIRS = TILE * CHUNK            # the most pairs one chunk can add


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(seed, n=1024, p=128, b=3, scale=1.5, tie_at_zero=False, duplicates=False):
    """Morton-sorted clouds (the first with a masked tail, the last all
    masked), features, centres on the points, and a two-scale bundle of
    (16, 16, 32) MLPs at radii 0.5 and 1.0.  ``tie_at_zero`` clamps the
    first 8 output columns to 0 (every in-ball pair ties); ``duplicates``
    copies the first 64 points of a cloud (features too) over its last 64,
    so equal values sit in different chunks."""
    rng = np.random.default_rng(seed)
    xyz = ops.spatial_sort(_t((rng.normal(size=(b, n, 3)) * scale).astype(np.float32)))[0].numpy()
    feats = rng.normal(size=(b, n, 1)).astype(np.float32)
    if duplicates:
        xyz[:, -64:], feats[:, -64:] = xyz[:, :64], feats[:, :64]
    mask = np.ones((b, n), bool)
    mask[0, n * 3 // 4:] = False
    mask[-1] = False
    centers = xyz[:, ::n // p][:, :p].copy()
    sw, sb = [], []
    for _ in range(2):
        dims = [4, 16, 16, 32]
        sw.append([jnp.asarray(rng.normal(size=(dims[i], dims[i + 1])) * 0.3, jnp.float32) for i in range(3)])
        sb.append([jnp.asarray(rng.normal(size=(dims[i + 1],)) * 0.1, jnp.float32) for i in range(3)])
    w, bias, radius = jax_bundle(sw, sb, (0.5, 1.0))
    w, bias = [np.asarray(x) for x in w], [np.array(x) for x in bias]
    if tie_at_zero:
        bias[-1][:8] = -100.0
    return xyz, feats, mask, centers, w, bias, radius


def _port(inputs, dtype):
    xyz, feats, mask, centers, w, bias, radius = inputs
    op = fused_sa.prepare(_t(xyz), _t(centers), [_t(x) for x in w], [_t(x) for x in bias], radius,
                          _t(feats), _t(mask), dtype)
    return op, fused_sa.block_min_d2_and_cull(op.pts4, op.centers, op.r2max)[1]


def _pair_values(op):
    """{(cloud, centre, point): the MLP's output row} from the calls the
    plain twins make."""
    tail_w = fused_sa._rounded_tail(op)
    vals = {}
    for s in range(0, op.pts4.shape[1], CHUNK):
        bi, pi, j, _ = fused_sa._chunk_pairs(op, s)
        if bi.numel():
            h = fused_sa._pair_mlp(op, tail_w, bi, pi, j)[-1].numpy()
            for row, key in enumerate(zip(bi.tolist(), pi.tolist(), j.tolist())):
                vals[key] = h[row]
    return vals


def _kept_chunks(bits):
    """The kept chunks as a block lists them, window by window: one byte a
    thread, a ballot a warp, each warp's kept chunks after those of the
    warps before it."""
    out = []
    for c0 in range(0, len(bits), WINDOW):
        keep = np.zeros(WINDOW, bool)
        keep[:len(bits[c0:c0 + WINDOW])] = bits[c0:c0 + WINDOW] != 0
        counts = [int(keep[32 * w:32 * (w + 1)].sum()) for w in range(WARPS)]
        window = [None] * sum(counts)
        for tid in np.nonzero(keep)[0]:
            warp, lane = divmod(int(tid), 32)
            window[sum(counts[:warp]) + int(keep[32 * warp:32 * warp + lane].sum())] = c0 + int(tid)
        out.extend(window)
    return out


def _append_chunk(op, bb, p0, c, lst):
    """Chunk c's in-radius pairs with the tile's centres, appended as the
    block appends them: (centre, warp) counts, scanned centre-major, then
    each hit at its offset plus its rank among its warp's hits."""
    n, p = op.pts4.shape[1], op.centers.shape[1]
    j = c * CHUNK + np.arange(CHUNK)
    pt = op.pts4[bb, np.minimum(j, n - 1)]
    valid = (j < n) & (pt[:, 3] == 0).numpy()
    hits = np.zeros((CHUNK, TILE), bool)
    d2s = np.zeros((CHUNK, TILE), np.float32)
    for t in range(min(TILE, p - p0)):
        ct = op.centers[bb, p0 + t]
        d2 = fused_sa._sq_dist(pt[:, 0], pt[:, 1], pt[:, 2], ct[0], ct[1], ct[2])
        d2s[:, t] = d2.numpy()
        hits[:, t] = valid & (d2 < op.r2max).numpy()
    counts = hits.reshape(WARPS, 32, TILE).sum(1).T.reshape(-1)   # index t * WARPS + warp
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    new = [None] * int(counts.sum())
    for tid, t in zip(*np.nonzero(hits)):
        warp, lane = divmod(int(tid), 32)
        rank = int(hits[32 * warp:32 * warp + lane, t].sum())  # hits of this centre in lower lanes
        new[offsets[t * WARPS + warp] + rank] = (int(j[tid]), int(t), d2s[tid, t])
    lst.extend(new)


def _keys(v, j, d2, r2, argmax):
    """A pair's max words for every column; 'no hit' outside a column's radius."""
    bits = v.astype(np.float32).view(np.uint32)
    inside = d2 < r2
    if argmax:
        return np.where(inside, (bits.astype(np.uint64) << np.uint64(32)) | np.uint64(~j & 0xFFFFFFFF),
                        np.uint64(0))
    return np.where(inside, bits.astype(np.int64), -1)


def _round(lst, vals, bb, p0, r2, smax, argmax, listed):
    """Four contiguous runs, one a warp; a centre's consecutive pairs are
    one register run, flushed into the shared max when the centre changes."""
    per = -(-len(lst) // WARPS)
    for w in range(WARPS):
        run = lst[w * per:(w + 1) * per]
        start = 0
        while start < len(run):
            t = run[start][1]
            end = start
            while end < len(run) and run[end][1] == t:
                end += 1
            keys = [_keys(vals[(bb, p0 + t, j)], j, d2, r2, argmax) for j, _, d2 in run[start:end]]
            smax[t] = np.maximum(smax[t], np.maximum.reduce(keys))
            listed.extend((bb, p0 + t, j) for j, _, _ in run[start:end])
            start = end


def _emulate(op, active, argmax, cap=LIST_CAP):
    """The kernel's forward, block by block -> (out, jstar or None, the
    listed pairs)."""
    b, nc, ntiles = active.shape
    p, h3 = op.centers.shape[1], op.r2.shape[0]
    vals, r2 = _pair_values(op), op.r2.numpy()
    smax = np.full((b, ntiles * TILE, h3), 0 if argmax else -1, np.uint64 if argmax else np.int64)
    listed = []
    for bb in range(b):
        for tile in range(ntiles):
            p0 = tile * TILE
            lst = []
            for c in _kept_chunks(active[bb, :, tile].numpy()):
                _append_chunk(op, bb, p0, c, lst)
                if len(lst) > cap - PAIRS:  # the next chunk might not fit
                    _round(lst, vals, bb, p0, r2, smax[bb, p0:p0 + TILE], argmax, listed)
                    lst = []
            if lst:
                _round(lst, vals, bb, p0, r2, smax[bb, p0:p0 + TILE], argmax, listed)
    smax = smax[:, :p]
    if argmax:
        out = np.where(smax == 0, 0, (smax >> np.uint64(32)).astype(np.uint32)).astype(np.uint32).view(np.float32)
        jstar = np.where(smax == 0, -1, (~(smax & np.uint64(0xFFFFFFFF))).astype(np.uint32).view(np.int32))
        return torch.from_numpy(out.copy()), torch.from_numpy(jstar.astype(np.int32)), listed, vals
    out = np.where(smax < 0, 0, smax).astype(np.uint32).view(np.float32)
    return torch.from_numpy(out.copy()), None, listed, vals


def test_kept_chunk_compaction_over_windows():
    """Several windows of 128 bitmap bytes, ragged last: the kept chunks in
    ascending order, each once."""
    bits = (np.random.default_rng(0).random(300) < 0.3).astype(np.uint8)
    assert _kept_chunks(bits) == list(np.nonzero(bits)[0])
    assert _kept_chunks(np.zeros(5, np.uint8)) == []


# The emulation and the twins take every pair's value from the same calls,
# and a max is exact, so they agree bit for bit in both dtypes; B5's values
# equal B2's bit for bit and its indices the twin's (lowest index on ties).
# cap = 2048 + 8 runs a round after nearly every kept chunk.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap", [LIST_CAP, PAIRS + 8])
@pytest.mark.parametrize("seed,kind", [(1, "plain"), (2, "tie_at_zero"), (3, "duplicates")])
def test_schedule_equals_plain_twins(dtype, cap, seed, kind):
    inputs = _inputs(seed, n=2048, tie_at_zero=kind == "tie_at_zero", duplicates=kind == "duplicates")
    op, active = _port(inputs, dtype)
    assert 0 < active.float().mean() < 1  # the sorted clouds do cull
    out, _, listed, vals = _emulate(op, active, argmax=False, cap=cap)
    assert len(listed) == len(set(listed)) and set(listed) == set(vals)  # every in-radius pair once
    assert torch.equal(out, fused_sa._fused_sa_plain(op))
    out_a, jstar, _, _ = _emulate(op, active, argmax=True, cap=cap)
    ref_out, ref_j = fused_sa._fused_sa_argmax_plain(op)
    assert torch.equal(out_a, out) and torch.equal(out_a, ref_out)
    assert torch.equal(jstar, ref_j)
    assert (jstar[-1] == -1).all() and not out[-1].any()  # the all-masked cloud
    if kind == "tie_at_zero":  # every in-ball value ties at 0: the lowest index wins
        assert (out[..., :8] == 0).all() and (jstar[:2, :, :8] >= 0).any()


def _dense_top2(op, vals):
    """Per (cloud, centre, column): the largest and second-largest value in
    the ball (-1 where fewer points), from the listed pairs' values."""
    b, p, h3 = op.pts4.shape[0], op.centers.shape[1], op.r2.shape[0]
    r2 = op.r2.numpy()
    top = np.full((b, p, h3, 2), -1.0, np.float32)
    for (bb, q, j), v in vals.items():
        d2 = fused_sa._sq_dist(*op.pts4[bb, j, :3], *op.centers[bb, q]).item()
        v = np.where(d2 < r2, v, -1.0)
        hi = np.maximum(top[bb, q, :, 0], v)
        top[bb, q, :, 1] = np.maximum(top[bb, q, :, 1], np.minimum(top[bb, q, :, 0], v))
        top[bb, q, :, 0] = hi
    return top[..., 0], top[..., 1]


# Against the TPU kernels: the same layer-1 split and rounding points, but
# another summation order in the tail, so float32 values agree to 1e-4 and
# bf16 ones to 2e-2 (a middle activation can land one bf16 ulp apart;
# tests/test_torch_ops.py states the same).  The TPU kernel breaks ties
# group-major, so winners are compared where the maximum is unique.
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_schedule_matches_pallas(dtype, atol):
    inputs = _inputs(4, n=1024, p=64)
    xyz, feats, mask, centers, w, bias, radius = inputs
    jw, jb = tuple(map(jnp.asarray, w)), tuple(map(jnp.asarray, bias))
    op, active = _port(inputs, getattr(torch, dtype))
    out, _, _, vals = _emulate(op, active, argmax=False)
    ref = np.asarray(ball_mlp_max_pallas(xyz, centers, jw, jb, radius, features=feats, mask=mask,
                                         compute_dtype=getattr(jnp, dtype), interpret=True))
    assert (ref[0] != 0).mean() > 0.3
    np.testing.assert_allclose(out.numpy(), ref, atol=atol, rtol=0)
    if dtype != "float32":
        return
    out_a, jstar, _, _ = _emulate(op, active, argmax=True)
    out_j, jstar_j = ball_mlp_max_pallas_argmax(xyz, centers, jw, jb, radius, features=feats, mask=mask,
                                                compute_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(out_a.numpy(), np.asarray(out_j), atol=atol, rtol=0)
    top1, top2 = _dense_top2(op, vals)
    unique = (top1 > 1e-3) & (top1 - top2 > 1e-3)
    assert unique.mean() > 0.2
    np.testing.assert_array_equal(jstar.numpy()[unique], np.asarray(jstar_j)[unique])
    empty = top1 < 0
    assert (jstar.numpy()[empty] == -1).all() and (np.asarray(jstar_j)[empty] == -1).all()
