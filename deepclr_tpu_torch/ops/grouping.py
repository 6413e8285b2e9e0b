"""Gather / group: index-select points or neighbourhoods (channel-last).

The forward is ``torch.gather``.  When the points need a gradient the
gather is an autograd Function whose backward, ``gather_points_grad``, sums
each source row's cotangents in ascending output order: on the card two
launches of the hand-written ``csrc/gather.cu`` (a run index of the index
built on the card, ``gather_bwd_index``, then one warp a source row), on
the CPU its plain twin (``scatter_add_``, sequential).  ``torch.gather``'s
own backward on the card adds with float atomics in an order that changes
from run to run, so two identical training runs would drift apart."""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ._cuda import CudaKernel, check_cuda

__all__ = ["gather_points", "gather_points_grad", "group_points", "gather_bwd_index", "gather_bwd_sum",
           "segment_length", "GATHER_BWD_KERNEL", "GATHER_BWD_INDEX_KERNEL", "MAX_ROWS"]

GATHER_BWD_INDEX_KERNEL = CudaKernel("gather_bwd_index", "gather", "deepclr_gather_bwd_index",
                                     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4)
GATHER_BWD_KERNEL = CudaKernel("gather_bwd", "gather", "deepclr_gather_bwd",
                               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5)
# source rows the card's run index takes: a warp keeps a count a row in
# shared memory (csrc/gather.cu)
MAX_ROWS = 65536


def segment_length(n: int) -> int:
    """Consecutive m a segment of the run index: a power of two near n / 8,
    from 128 to 16384.  A warp walks its segment 32 m at a time, so a
    shorter segment means more warps and a shorter walk; every segment
    keeps n + 1 counts, so S (n + 1), about 8 M + n, bounds the offsets,
    and a warp's shared arrays (6 lseg + 2 (n + 1) bytes) stay within 227
    KB up to n = MAX_ROWS."""
    return min(16384, max(128, (1 << max(0, n - 1).bit_length()) // 8))


def _gather_bwd_index_plain(idx: torch.Tensor, n: int, lseg: int):
    """The run index's twin: each segment of ``lseg`` consecutive m sorted
    stably by index (an index outside [0, n) as n, after every row).
    perm (B, M) int32 holds segment s's m at s * lseg + [0, len);
    offsets (B, S, n + 1) int16, offsets[b, s, k] the m of segment s whose
    index is below k."""
    b, m = idx.shape
    segs = -(-m // lseg)
    key = torch.where((idx >= 0) & (idx < n), idx.long(), n)
    key = torch.nn.functional.pad(key, (0, segs * lseg - m), value=n + 1).view(b, segs, lseg)
    keys, order = torch.sort(key, dim=-1, stable=True)
    base = torch.arange(segs, device=idx.device).view(1, segs, 1) * lseg
    perm = (order + base).view(b, segs * lseg)[:, :m].to(torch.int32)
    rows = torch.arange(n + 1, device=idx.device).expand(b, segs, -1).contiguous()
    offsets = torch.searchsorted(keys.contiguous(), rows).to(torch.int16)
    return perm.contiguous(), offsets


def gather_bwd_index(idx: torch.Tensor, n: int):
    """The run index of idx (B, M) into n rows (``segment_length(n)`` m a
    segment): (perm (B, M) int32, offsets (B, S, n + 1) int16), as
    ``_gather_bwd_index_plain`` gives it; one launch on the card."""
    lseg = segment_length(n)
    if not idx.is_cuda:
        return _gather_bwd_index_plain(idx, n, lseg)
    if n > MAX_ROWS:
        raise ValueError(f"gather_bwd_index: at most {MAX_ROWS} source rows on the card, got {n}")
    check_cuda("gather_bwd_index", idx, dtype=torch.int64)
    b, m = idx.shape
    perm = torch.empty((b, m), dtype=torch.int32, device=idx.device)
    offsets = torch.empty((b, -(-m // lseg), n + 1), dtype=torch.int16, device=idx.device)
    if m:
        GATHER_BWD_INDEX_KERNEL.launch(idx.device, idx.data_ptr(), perm.data_ptr(), offsets.data_ptr(),
                                       b, m, n, lseg)
    return perm, offsets


def _gather_points_grad_plain(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    b, _, c = g.shape
    return torch.zeros((b, n, c), dtype=torch.float32, device=g.device).scatter_add_(
        1, idx.long()[..., None].expand(-1, -1, c), g.float())


def _gather_bwd_sum_plain(g: torch.Tensor, perm: torch.Tensor, offsets: torch.Tensor, n: int) -> torch.Tensor:
    """The sum launch's twin: each row's run read from the run index,
    segment by segment, and added left to right (one entry of every row a
    step)."""
    b, m, c = g.shape
    dev = g.device
    out = torch.zeros((b, n, c), dtype=torch.float32, device=dev)
    lseg = segment_length(n)
    for bb in range(b):
        off = offsets[bb].long()                                   # (S, n + 1)
        segs = off.shape[0]
        sizes = off[:, 1:] - off[:, :-1]                           # (S, n): a row's entries in a segment
        row = torch.repeat_interleave(torch.arange(n, device=dev).repeat(segs), sizes.reshape(-1))
        seg = torch.repeat_interleave(torch.arange(segs, device=dev), off[:, n])
        first = torch.cumsum(off[:, n], 0) - off[:, n]
        at = seg * lseg + torch.arange(len(seg), device=dev) - first[seg]  # segment-major, as row is
        order = torch.argsort(row, stable=True)                     # by row, then segment and position
        row, src = row[order], perm[bb].long()[at[order]]
        rank = torch.arange(len(row), device=dev) - torch.searchsorted(row, row)
        for r in range(int(rank.max()) + 1 if len(rank) else 0):
            sel = rank == r
            out[bb].index_add_(0, row[sel], g[bb, src[sel]].float())
    return out


def gather_bwd_sum(g: torch.Tensor, perm: torch.Tensor, offsets: torch.Tensor, n: int) -> torch.Tensor:
    """The sum over a run index (``gather_bwd_index`` of the same idx and n):
    g (B, M, C) float32 -> (B, n, C) float32; one launch on the card."""
    if not g.is_cuda:
        return _gather_bwd_sum_plain(g, perm, offsets, n)
    b, m, c = g.shape
    check_cuda("gather_bwd", g)
    check_cuda("gather_bwd", perm, dtype=torch.int32)
    check_cuda("gather_bwd", offsets, dtype=torch.int16)
    if perm.shape != (b, m) or offsets.shape != (b, -(-m // segment_length(n)), n + 1):
        raise ValueError(f"gather_bwd: a run index of {tuple(perm.shape)}, {tuple(offsets.shape)} for g "
                         f"{tuple(g.shape)} into {n} rows")
    out = torch.empty((b, n, c), dtype=torch.float32, device=g.device)
    GATHER_BWD_KERNEL.launch(g.device, g.data_ptr(), perm.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                             b, m, n, c, segment_length(n))
    return out


def gather_points_grad(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The gather's backward: g (B, M, C) cotangents of the gathered rows,
    idx (B, M) their source rows in [0, n) -> (B, n, C) float32, row j the
    sum of g[b, m] over m with idx[b, m] = j, in ascending m.  On the card:
    the run index, then the sum (``gather_bwd_index``, ``gather_bwd_sum``),
    two launches."""
    if g.dim() != 3 or idx.shape != g.shape[:2]:
        raise ValueError(f"gather_points_grad: expected g (B, M, C) and idx (B, M), got {tuple(g.shape)} "
                         f"and {tuple(idx.shape)}")
    if not g.is_cuda:
        return _gather_points_grad_plain(g, idx, n)
    perm, offsets = gather_bwd_index(idx.long().contiguous(), n)
    return gather_bwd_sum(g.float().contiguous(), perm, offsets, n)


class _Gather(torch.autograd.Function):
    """out = points[b, idx[b, m]]; the backward is ``gather_points_grad``."""

    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.n, ctx.dtype = points.shape[1], points.dtype
        return torch.gather(points, 1, idx[..., None].expand(-1, -1, points.shape[-1]))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return gather_points_grad(g, idx, ctx.n).to(ctx.dtype), None


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) points, (B, P) indices -> (B, P, C)."""
    idx = idx.long()
    if points.requires_grad and torch.is_grad_enabled():
        return _Gather.apply(points, idx)
    return torch.gather(points, 1, idx[..., None].expand(-1, -1, points.shape[-1]))


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) points, (B, P, S) indices -> (B, P, S, C)."""
    b, p, s = idx.shape
    return gather_points(points, idx.reshape(b, p * s)).reshape(b, p, s, -1)
