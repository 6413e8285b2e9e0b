"""Gather / group: index-select points or neighbourhoods (channel-last).

The forward is ``torch.gather``.  When the points need a gradient the
gather is an autograd Function whose backward, ``gather_points_grad``, sums
each source row's cotangents in ascending output order: on the card the
hand-written kernel ``csrc/gather.cu`` over a CSR of the index built by a
stable sort, on the CPU its plain twin (``scatter_add_``, sequential).
``torch.gather``'s own backward on the card adds with float atomics in an
order that changes from run to run, so two identical training runs would
drift apart."""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ._cuda import CudaKernel, check_cuda

__all__ = ["gather_points", "gather_points_grad", "group_points", "GATHER_BWD_KERNEL"]

GATHER_BWD_KERNEL = CudaKernel("gather_bwd", "gather", "deepclr_gather_bwd",
                               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4)


def _gather_points_grad_plain(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    b, _, c = g.shape
    return torch.zeros((b, n, c), dtype=torch.float32, device=g.device).scatter_add_(
        1, idx.long()[..., None].expand(-1, -1, c), g.float())


def gather_points_grad(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The gather's backward: g (B, M, C) cotangents of the gathered rows,
    idx (B, M) their source rows in [0, n) -> (B, n, C) float32, row j the
    sum of g[b, m] over m with idx[b, m] = j, in ascending m."""
    if g.dim() != 3 or idx.shape != g.shape[:2]:
        raise ValueError(f"gather_points_grad: expected g (B, M, C) and idx (B, M), got {tuple(g.shape)} "
                         f"and {tuple(idx.shape)}")
    if not g.is_cuda:
        return _gather_points_grad_plain(g, idx, n)
    b, m, c = g.shape
    g = g.float().contiguous()
    order = torch.sort(idx, dim=1, stable=True)
    rows = torch.arange(n + 1, device=g.device, dtype=order.values.dtype).expand(b, -1).contiguous()
    offsets = torch.searchsorted(order.values.contiguous(), rows).to(torch.int32)
    perm = order.indices.to(torch.int32).contiguous()
    check_cuda("gather_bwd", g)
    check_cuda("gather_bwd", perm, offsets, dtype=torch.int32)
    out = torch.empty((b, n, c), dtype=torch.float32, device=g.device)
    GATHER_BWD_KERNEL.launch(g.device, g.data_ptr(), perm.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                             b, m, n, c)
    return out


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
