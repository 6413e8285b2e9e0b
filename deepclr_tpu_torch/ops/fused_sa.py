"""Fused set-abstraction scale: ball query + shared MLP + max-pool as one
streaming computation that never materializes neighbour indices.

    out[p, c] = max over valid j with |x_j - c_p|^2 < r_c^2 of MLP(x_j - c_p || f_j)[c]

(0 for an empty ball).  Layer 1 is affine in (dx || f), so it splits into a
per-point term a_j = x_j W1x + f_j W1f + b1 and a per-centre term
bc_p = -c_p W1x; a pair's pre-activation is relu(a_j + bc_p), in float32.
The tail layers take inputs rounded to the compute dtype, accumulate in
float32, add a float32 bias and apply ReLU.  Multi-scale bundles pass
block-diagonal tail weights and one radius per output column, so every MSG
scale shares one pass over the cloud.

Two hand-written CUDA kernels carry the op on the card, each with a plain
PyTorch twin that a CPU tensor runs:

* ``block_min_d2`` (``csrc/min_d2.cu``): the culling pre-pass, min d^2 over
  each chunk of consecutive points for every centre;
* ``fused_sa_core`` (``csrc/fused_sa.cu``): the forward itself, skipping the
  (chunk, centre tile) blocks that ``cull_bitmap`` rules out.

Distances are the dx^2 form (x - c)^2 summed x, y, z with every product
rounded, in both kernels and both twins, so culling and radius decisions
agree bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ._cuda import CudaKernel, check_cuda

__all__ = [
    "ball_mlp_max",
    "block_min_d2",
    "cull_bitmap",
    "fused_sa_core",
    "multi_scale_bundle",
    "prepare",
    "SAOperands",
    "MIN_D2_KERNEL",
    "FUSED_SA_KERNEL",
    "CHUNK",
    "TILE",
    "KERNEL_WIDTHS",
]

BIG = 1e12        # d^2 penalty of an invalid point
NEG = -1e30       # running-max identity; an empty ball ends at 0
CHUNK = 128       # points per culling chunk (csrc/fused_sa.cu kChunk)
TILE = 16         # centres per block (csrc/fused_sa.cu kTile)
KERNEL_WIDTHS = (32, 32, 64)  # (H1, H2, H3) compiled in csrc/fused_sa.cu: every shipped config

_P = ctypes.c_void_p
_I = ctypes.c_int
MIN_D2_KERNEL = CudaKernel("min_d2", "min_d2", "deepclr_min_d2", [_P, _P, _P, _I, _I, _I, _I])
FUSED_SA_KERNEL = CudaKernel(
    "fused_sa", "fused_sa", "deepclr_fused_sa",
    [_P] * 11 + [_I] * 8 + [ctypes.c_float, _I],
)


def multi_scale_bundle(scale_weights, scale_biases, radii):
    """Combine per-scale MLP params into one fused bundle.

    scale_weights: per scale [w1 (Cin, h1), w2 (h1, h2), ...] ((in, out)
    layout); scale_biases: the matching biases; radii: one per scale.
    Returns (weights, biases, radius_cols): layer-1 weights concatenated on
    the output axis, tail layers block-diagonal, one radius per output column.
    """
    weights = [torch.cat([w[0] for w in scale_weights], dim=1)]
    biases = [torch.cat([b[0] for b in scale_biases], dim=0)]
    for li in range(1, len(scale_weights[0])):
        weights.append(torch.block_diag(*[w[li] for w in scale_weights]))
        biases.append(torch.cat([b[li] for b in scale_biases], dim=0))
    radius_cols = tuple(float(r) for r, w in zip(radii, scale_weights) for _ in range(w[-1].shape[1]))
    return weights, biases, radius_cols


def _sq_dist(px, py, pz, cx, cy, cz):
    """(x - c)^2 summed x, y, z, each product rounded: the kernels' form."""
    dx = px - cx
    d2 = dx * dx
    dy = py - cy
    d2 = d2 + dy * dy
    dz = pz - cz
    return d2 + dz * dz


def _block_min_d2_plain(pts4: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    b, n, _ = pts4.shape
    nc = -(-n // CHUNK)
    out = torch.empty((b, nc, centers.shape[1]), dtype=torch.float32, device=pts4.device)
    cx, cy, cz = (centers[:, None, :, k] for k in range(3))
    for c in range(nc):
        s = pts4[:, c * CHUNK:(c + 1) * CHUNK, None, :]            # (B, C, 1, 4)
        d2 = _sq_dist(s[..., 0], s[..., 1], s[..., 2], cx, cy, cz) + s[..., 3]
        out[:, c] = torch.amin(d2, dim=1)
    return out


def _pack_points(xyz: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, N, 4) float32: x, y, z, BIG*invalid."""
    inval = torch.zeros_like(xyz[..., 0]) if mask is None else (~mask).to(torch.float32) * BIG
    return torch.cat([xyz, inval[..., None]], dim=-1).contiguous()


def block_min_d2(pts4: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Culling pre-pass.  pts4 (B, N, 4) = x, y, z, BIG*invalid; centers
    (B, P, 3) -> (B, ceil(N/CHUNK), P): the min over each chunk of CHUNK
    consecutive points of d^2 + BIG*invalid.  A ragged last chunk takes the
    min over the points it has."""
    if pts4.dim() != 3 or pts4.shape[-1] != 4 or centers.shape[-1] != 3:
        raise ValueError("block_min_d2: expected pts4 (B, N, 4) and centers (B, P, 3)")
    if not pts4.is_cuda:
        return _block_min_d2_plain(pts4, centers)
    centers = centers.contiguous()
    check_cuda("block_min_d2", pts4, centers)
    b, n, _ = pts4.shape
    p = centers.shape[1]
    out = torch.empty((b, -(-n // CHUNK), p), dtype=torch.float32, device=pts4.device)
    MIN_D2_KERNEL.launch(pts4.device, pts4.data_ptr(), centers.data_ptr(), out.data_ptr(),
                         b, n, p, CHUNK)
    return out


def cull_bitmap(min_d2: torch.Tensor, r2max: float) -> torch.Tensor:
    """Fold the pre-pass into a visit bitmap (B, n_chunks, ceil(P/TILE))
    uint8: a (chunk, centre tile) block is visited unless even its closest
    pair, shrunk by a 1% + 1e-3 margin, lies outside the largest radius.
    The margin only adds visits; the kernel tests every pair exactly."""
    b, nc, p = min_d2.shape
    pad = -p % TILE
    if pad:
        min_d2 = torch.cat([min_d2, min_d2.new_full((b, nc, pad), float("inf"))], dim=-1)
    lower = torch.amin(min_d2.view(b, nc, -1, TILE), dim=-1) * (1.0 - 1e-2) - 1e-3
    return (lower < r2max).to(torch.uint8).contiguous()


class SAOperands(NamedTuple):
    """Prepared operands of the fused forward (``prepare``)."""

    pts4: torch.Tensor          # (B, N, 4): x, y, z, BIG*invalid
    a: torch.Tensor             # (B, N, H1) layer-1 point term, float32
    centers: torch.Tensor       # (B, P, 3)
    bc: torch.Tensor            # (B, P, H1) layer-1 centre term, float32
    tail_w: List[torch.Tensor]  # (in, out) float32, rounded to the compute dtype
    tail_b: List[torch.Tensor]  # float32
    r2: torch.Tensor            # (H3,) per-column squared radii, float32
    r2max: float                # max of r2, kept on the host
    compute_dtype: torch.dtype


def prepare(xyz, centers, weights, biases, radius, features=None, mask=None,
            compute_dtype=torch.bfloat16) -> SAOperands:
    """Operands of ``fused_sa_core``: the packed points, the layer-1 split
    terms, the rounded tail weights and the squared radii.  The radii go to
    the device without a stream sync, and their max stays on the host, so
    preparing drains no launch queue."""
    w1 = weights[0].float()
    w1x = w1[:3]
    a = torch.matmul(xyz, w1x)
    if features is not None:
        a = a + torch.matmul(features, w1[3:])
    a = a + biases[0].float()
    bc = -torch.matmul(centers, w1x)
    h3 = weights[-1].shape[1]
    radii = radius if isinstance(radius, (tuple, list)) else (float(radius),) * h3
    if len(radii) != h3:
        raise ValueError(f"ball_mlp_max: {len(radii)} radii for {h3} output columns")
    r2 = np.square(np.asarray(radii, np.float32))
    return SAOperands(
        _pack_points(xyz, mask), a.contiguous(), centers.contiguous(), bc.contiguous(),
        [w.to(compute_dtype).float().contiguous() for w in weights[1:]],
        [bb.float().contiguous() for bb in biases[1:]],
        torch.from_numpy(r2).to(xyz.device, non_blocking=True), float(r2.max()), compute_dtype)


def _fused_sa_plain(op: SAOperands) -> torch.Tensor:
    """Reference of the forward, chunked over points.  Every pair's
    distance is tested; only pairs inside the largest radius run the MLP,
    and each column keeps the pairs inside its own radius."""
    b, n, _ = op.pts4.shape
    p = op.centers.shape[1]
    h3 = op.r2.shape[0]
    out = torch.full((b * p, h3), NEG, dtype=torch.float32, device=op.pts4.device)
    cx, cy, cz = (op.centers[:, :, None, k] for k in range(3))
    for s in range(0, n, CHUNK):
        blk = op.pts4[:, None, s:s + CHUNK, :]                           # (B, 1, C, 4)
        d2 = _sq_dist(blk[..., 0], blk[..., 1], blk[..., 2], cx, cy, cz)  # (B, P, C)
        bi, pi, ji = torch.nonzero((d2 < op.r2max) & (blk[..., 3] == 0), as_tuple=True)
        if bi.numel() == 0:
            continue
        h = torch.relu(op.a[bi, s + ji] + op.bc[bi, pi])
        for w, bias in zip(op.tail_w, op.tail_b):
            h = torch.relu(torch.matmul(h.to(op.compute_dtype).float(), w) + bias)
        h = torch.where(d2[bi, pi, ji][:, None] < op.r2, h, NEG)
        out.scatter_reduce_(0, (bi * p + pi)[:, None].expand(-1, h3), h, reduce="amax")
    out = torch.where(out <= NEG / 2, 0.0, out)
    return out.view(b, p, h3)


def fused_sa_core(op: SAOperands, active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused forward on prepared operands -> (B, P, H3) float32.
    ``active`` is the culling bitmap (``cull_bitmap``) the kernel needs; the
    plain twin tests every pair and takes none."""
    if not op.pts4.is_cuda:
        return _fused_sa_plain(op)
    widths = (op.a.shape[-1], *(w.shape[1] for w in op.tail_w))
    if widths != KERNEL_WIDTHS:
        raise ValueError(f"fused_sa kernel: tail widths {widths} not compiled (only {KERNEL_WIDTHS})")
    if op.compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_sa kernel: unsupported compute dtype {op.compute_dtype}")
    b, n, _ = op.pts4.shape
    p = op.centers.shape[1]
    if active is None or active.shape != (b, -(-n // CHUNK), -(-p // TILE)):
        raise ValueError("fused_sa kernel: a culling bitmap of (B, ceil(N/CHUNK), ceil(P/TILE)) is required")
    check_cuda("fused_sa", op.pts4, op.a, op.centers, op.bc, *op.tail_w, *op.tail_b, op.r2)
    check_cuda("fused_sa", active, dtype=torch.uint8)
    (w2, w3), (b2, b3) = op.tail_w, op.tail_b
    out = torch.empty((b, p, widths[-1]), dtype=torch.float32, device=op.pts4.device)
    FUSED_SA_KERNEL.launch(
        op.pts4.device, op.pts4.data_ptr(), op.a.data_ptr(), op.centers.data_ptr(), op.bc.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), op.r2.data_ptr(),
        active.data_ptr(), out.data_ptr(), b, n, p, *widths, CHUNK, TILE,
        op.r2max, int(op.compute_dtype == torch.bfloat16))
    return out


def ball_mlp_max(xyz: torch.Tensor, centers: torch.Tensor, weights, biases, radius,
                 features: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Fused radius-neighbourhood PointNet scale (forward).

    xyz (B, N, 3) float32, centers (B, P, 3), weights/biases per layer in
    (in, out) layout, radius a float or one per output column, optional
    features (B, N, F) and validity mask (B, N) -> (B, P, H_last) float32.
    On the card: the culling pre-pass kernel, the bitmap fold, then the
    fused kernel; on the CPU: the plain forward.
    """
    op = prepare(xyz, centers, weights, biases, radius, features, mask, compute_dtype)
    active = cull_bitmap(block_min_d2(op.pts4, op.centers), op.r2max) if op.pts4.is_cuda else None
    return fused_sa_core(op, active)
