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

Hand-written CUDA kernels carry the op on the card, each with a plain
PyTorch twin that a CPU tensor runs:

* ``block_min_d2`` (``csrc/min_d2.cu``): the culling pre-pass, min d^2 over
  each chunk of consecutive points for every centre;
  ``block_min_d2_and_cull`` runs the same kernel and also writes the
  culling bitmap (``cull_bitmap`` of its output) from the same launch;
* ``fused_sa_core`` (``csrc/fused_sa.cu``): the forward itself, skipping the
  (chunk, centre tile) blocks that ``cull_bitmap`` rules out;
* ``fused_sa_argmax`` (same source): the forward plus each column's winning
  point index;
* ``fused_sa_bwd`` (same source): the equality-select backward, two
  launches: the kernel itself (its entry point first reduces g to the
  fixed-point scale of da, ``da_scale``'s kernel), then
  ``fused_sa_bwd_finish``, which sums its per-block dW / db rows in block
  order and converts its fixed-point da, NaN where a selected pair's float
  chain was not finite.  Two launches on the same operands give the same
  bits.

Distances are the dx^2 form (x - c)^2 summed x, y, z with every product
rounded, in every kernel and twin, so culling and radius decisions agree bit
for bit.

Differentiation (``ball_mlp_max``): an autograd Function whose inputs are
the layer-1 terms ``a`` and ``bc`` and the float32 tail weights and biases;
``a`` and ``bc`` are plain matmuls outside it, so autograd assembles the
layer-1 and input gradients.  Two backwards, as in the JAX package:

* ``"kernel"`` (default): recompute every in-radius pair, select the rows
  whose value equals the forward's own output, back-propagate the tail there.
  Every tied row gets the full cotangent.
* ``"argmax"``: the forward records each column's winner (the lowest point
  index among equal values); the backward re-evaluates the MLP in float32 at
  the winners only.

The tail weights are rounded to the compute dtype inside the Function, so
their gradients come back in float32, unrounded.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ._cuda import CudaKernel, check_cuda
from .grouping import gather_points_grad

__all__ = [
    "ball_mlp_max",
    "block_min_d2",
    "block_min_d2_and_cull",
    "cull_bitmap",
    "fused_sa_core",
    "fused_sa_argmax",
    "fused_sa_bwd",
    "fused_sa_bwd_finish",
    "da_scale",
    "multi_scale_bundle",
    "prepare",
    "SAOperands",
    "MIN_D2_KERNEL",
    "FUSED_SA_KERNEL",
    "FUSED_SA_ARGMAX_KERNEL",
    "FUSED_SA_BWD_KERNEL",
    "FUSED_SA_BWD_FINISH_KERNEL",
    "CHUNK",
    "TILE",
    "KERNEL_WIDTHS",
]

BIG = 1e12        # d^2 penalty of an invalid point
NEG = -1e30       # running-max identity; an empty ball ends at 0
CHUNK = 128       # points per culling chunk (csrc/fused_sa.cu kChunk)
TILE = 16         # centres per block (csrc/fused_sa.cu kTile)
KERNEL_WIDTHS = (32, 32, 64)  # (H1, H2, H3) compiled in csrc/fused_sa.cu: every shipped config
BACKWARDS = ("kernel", "argmax")
# a block's row of B4's dW / db workspace (csrc/fused_sa.cu kPartWidth):
# dW3, dW2, db3, db2 at KERNEL_WIDTHS
PART_SPLIT = (32 * 64, 32 * 32, 64, 32)
PART_WIDTH = sum(PART_SPLIT)
# B4's fixed-point state (csrc/fused_sa.cu kStateWords): S, the flags, two
# words of the scale launch, then one flag word a point of da (bit k: lane
# k's sum was not finite)
DA_STATE_WORDS = 4
DA_G_NONFINITE = 1      # g holds a NaN or an inf
DA_BOUND_NONFINITE = 2  # the bound is not finite (a weight is not): all of da is NaN

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
MIN_D2_KERNEL = CudaKernel("min_d2", "min_d2", "deepclr_min_d2", [_P] * 4 + [_I] * 5 + [_F])
FUSED_SA_KERNEL = CudaKernel("fused_sa", "fused_sa", "deepclr_fused_sa", [_P] * 11 + [_I] * 8 + [_F, _I])
FUSED_SA_ARGMAX_KERNEL = CudaKernel(
    "fused_sa_argmax", "fused_sa", "deepclr_fused_sa_argmax", [_P] * 12 + [_I] * 8 + [_F, _I])
FUSED_SA_BWD_KERNEL = CudaKernel(
    "fused_sa_bwd", "fused_sa", "deepclr_fused_sa_bwd", [_P] * 16 + [_I] * 8 + [_F, _I])
FUSED_SA_BWD_FINISH_KERNEL = CudaKernel(
    "fused_sa_bwd_finish", "fused_sa", "deepclr_fused_sa_bwd_finish",
    [_P, _I, _P, _P, ctypes.c_longlong] + [_P] * 5)


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


def _launch_min_d2(name, pts4, centers, r2max=None):
    """The pre-pass kernel -> (min_d2, the bitmap or None); with ``r2max``
    it also writes the bitmap."""
    centers = centers.contiguous()
    check_cuda(name, pts4, centers)
    b, n, _ = pts4.shape
    p = centers.shape[1]
    nc = -(-n // CHUNK)
    out = torch.empty((b, nc, p), dtype=torch.float32, device=pts4.device)
    active = None if r2max is None else torch.empty((b, nc, -(-p // TILE)), dtype=torch.uint8,
                                                    device=pts4.device)
    MIN_D2_KERNEL.launch(pts4.device, pts4.data_ptr(), centers.data_ptr(), out.data_ptr(),
                         None if active is None else active.data_ptr(), b, n, p, CHUNK, TILE,
                         0.0 if r2max is None else float(r2max))
    return out, active


def _check_pre_pass_shapes(name, pts4, centers):
    if pts4.dim() != 3 or pts4.shape[-1] != 4 or centers.shape[-1] != 3:
        raise ValueError(f"{name}: expected pts4 (B, N, 4) and centers (B, P, 3)")


def block_min_d2(pts4: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Culling pre-pass.  pts4 (B, N, 4) = x, y, z, BIG*invalid; centers
    (B, P, 3) -> (B, ceil(N/CHUNK), P): the min over each chunk of CHUNK
    consecutive points of d^2 + BIG*invalid.  A ragged last chunk takes the
    min over the points it has."""
    _check_pre_pass_shapes("block_min_d2", pts4, centers)
    if not pts4.is_cuda:
        return _block_min_d2_plain(pts4, centers)
    return _launch_min_d2("block_min_d2", pts4, centers)[0]


def block_min_d2_and_cull(pts4: torch.Tensor, centers: torch.Tensor, r2max: float):
    """The pre-pass and its culling bitmap -> (min_d2, active), equal to
    ``(block_min_d2(pts4, centers), cull_bitmap(min_d2, r2max))``; on the
    card one launch writes both."""
    _check_pre_pass_shapes("block_min_d2_and_cull", pts4, centers)
    if not pts4.is_cuda:
        min_d2 = _block_min_d2_plain(pts4, centers)
        return min_d2, cull_bitmap(min_d2, r2max)
    return _launch_min_d2("block_min_d2_and_cull", pts4, centers, r2max)


def cull_bitmap(min_d2: torch.Tensor, r2max: float) -> torch.Tensor:
    """Fold the pre-pass into a visit bitmap (B, n_chunks, ceil(P/TILE))
    uint8: a (chunk, centre tile) block is visited unless even its closest
    pair, shrunk by a 1% + 1e-3 margin, lies outside the largest radius.
    The margin only adds visits; the kernel tests every pair exactly.  The
    plain twin of the bitmap ``block_min_d2_and_cull`` writes on the card."""
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
    tail_w: List[torch.Tensor]  # (in, out) float32, not rounded: the kernels round them
    tail_b: List[torch.Tensor]  # float32
    r2: torch.Tensor            # (H3,) per-column squared radii, float32
    r2max: float                # max of r2, kept on the host
    compute_dtype: torch.dtype


_r2_cache: Dict[Tuple[Tuple[float, ...], torch.device], Tuple[torch.Tensor, float]] = {}


def _squared_radii(radii, device: torch.device) -> Tuple[torch.Tensor, float]:
    """(the per-column squared radii as a float32 tensor on ``device``,
    their max as a host float), made once for each radius tuple and device
    and then shared: a CUDA graph cannot capture the copy from pageable
    host memory that a fresh tensor a call would need.  The tensor is made
    outside inference mode, so training may use one that an inference call
    made; nothing writes to it."""
    key = (tuple(radii), device)
    if key not in _r2_cache:
        r2 = np.square(np.asarray(radii, np.float32))
        with torch.inference_mode(False):
            _r2_cache[key] = (torch.from_numpy(r2).to(device), float(r2.max()))
    return _r2_cache[key]


def prepare(xyz, centers, weights, biases, radius, features=None, mask=None,
            compute_dtype=torch.bfloat16) -> SAOperands:
    """Operands of the fused kernels: the packed points, the layer-1 split
    terms (differentiable torch ops), the float32 tail and the squared radii.
    The squared radii are one tensor a radius tuple and device
    (``_squared_radii``), and their max stays on the host, so preparing
    drains no launch queue and copies nothing from the host."""
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
    r2, r2max = _squared_radii(radii, xyz.device)
    return SAOperands(
        _pack_points(xyz.detach(), mask), a.contiguous(), centers.detach().contiguous(), bc.contiguous(),
        [w.float().contiguous() for w in weights[1:]], [bb.float().contiguous() for bb in biases[1:]],
        r2, r2max, compute_dtype)


def _rounded_tail(op: SAOperands) -> List[torch.Tensor]:
    """The tail weights as the kernels use them: rounded to the compute
    dtype, held in float32, outside autograd."""
    return [w.detach().to(op.compute_dtype).float().contiguous() for w in op.tail_w]


# ---- plain twins ------------------------------------------------------------

def _chunk_pairs(op: SAOperands, s: int):
    """In-radius pairs of valid points [s, s + CHUNK) with every centre:
    (cloud, centre, point, d^2), each (K,)."""
    cx, cy, cz = (op.centers[:, :, None, k] for k in range(3))
    blk = op.pts4[:, None, s:s + CHUNK, :]                           # (B, 1, C, 4)
    d2 = _sq_dist(blk[..., 0], blk[..., 1], blk[..., 2], cx, cy, cz)  # (B, P, C)
    bi, pi, ji = torch.nonzero((d2 < op.r2max) & (blk[..., 3] == 0), as_tuple=True)
    return bi, pi, s + ji, d2[bi, pi, ji]


def _pair_mlp(op: SAOperands, tail_w, bi, pi, j) -> List[torch.Tensor]:
    """Float32 activations of the listed pairs: relu(a + bc), then each tail
    layer's output on its input rounded to the compute dtype."""
    hs = [torch.relu(op.a[bi, j] + op.bc[bi, pi])]
    for w, bias in zip(tail_w, op.tail_b):
        hs.append(torch.relu(torch.matmul(hs[-1].to(op.compute_dtype).float(), w) + bias))
    return hs


def _fused_sa_plain(op: SAOperands) -> torch.Tensor:
    """Reference of the forward, chunked over points.  Every pair's
    distance is tested; only pairs inside the largest radius run the MLP,
    and each column keeps the pairs inside its own radius."""
    b, n, _ = op.pts4.shape
    p, h3 = op.centers.shape[1], op.r2.shape[0]
    tail_w = _rounded_tail(op)
    out = torch.full((b * p, h3), NEG, dtype=torch.float32, device=op.pts4.device)
    for s in range(0, n, CHUNK):
        bi, pi, j, d2 = _chunk_pairs(op, s)
        if bi.numel() == 0:
            continue
        h = _pair_mlp(op, tail_w, bi, pi, j)[-1]
        h = torch.where(d2[:, None] < op.r2, h, NEG)
        out.scatter_reduce_(0, (bi * p + pi)[:, None].expand(-1, h3), h, reduce="amax")
    out = torch.where(out <= NEG / 2, 0.0, out)
    return out.view(b, p, h3)


def _fused_sa_argmax_plain(op: SAOperands):
    """Reference of the argmax forward -> (out, jstar int32): the winner is
    the lowest point index among the column's equal maxima, -1 when the
    ball is empty (the kernel's rule)."""
    b, n, _ = op.pts4.shape
    p, h3 = op.centers.shape[1], op.r2.shape[0]
    out = _fused_sa_plain(op)
    flat = out.view(b * p, h3)
    tail_w = _rounded_tail(op)
    jstar = torch.full((b * p, h3), n, dtype=torch.int64, device=op.pts4.device)
    for s in range(0, n, CHUNK):
        bi, pi, j, d2 = _chunk_pairs(op, s)
        if bi.numel() == 0:
            continue
        row = bi * p + pi
        h = _pair_mlp(op, tail_w, bi, pi, j)[-1]
        win = (d2[:, None] < op.r2) & (h == flat[row])
        jstar.scatter_reduce_(0, row[:, None].expand(-1, h3), torch.where(win, j[:, None], n),
                              reduce="amin")
    return out, torch.where(jstar == n, -1, jstar).to(torch.int32).view(b, p, h3)


def _fused_sa_bwd_plain(op: SAOperands, out: torch.Tensor, g: torch.Tensor):
    """Reference of the equality-select backward -> (da, dbc, dW_tail,
    db_tail).  A column of a pair is selected when the pair is inside the
    column's radius and its recomputed value equals ``out`` (the forward's
    own output); every tied row gets the full cotangent.  relu' selects
    where h > 0, as the kernel and the Pallas backward do (a product with
    (h > 0) would spread a NaN or inf of a selected pair's chain to the
    inactive units); the layer input and delta are rounded to the compute
    dtype before each product; sums and db stay float32 (the TPU kernel's
    rounding points)."""
    b, n, _ = op.pts4.shape
    p, h3 = op.centers.shape[1], op.r2.shape[0]
    cd = op.compute_dtype
    tail_w = _rounded_tail(op)
    flat_out, flat_g = out.reshape(b * p, h3), g.reshape(b * p, h3)
    da, dbc = torch.zeros_like(op.a), torch.zeros_like(op.bc)
    dw = [torch.zeros_like(w) for w in tail_w]
    db = [torch.zeros_like(x) for x in op.tail_b]
    for s in range(0, n, CHUNK):
        bi, pi, j, d2 = _chunk_pairs(op, s)
        if bi.numel() == 0:
            continue
        row = bi * p + pi
        hs = _pair_mlp(op, tail_w, bi, pi, j)
        sel = (d2[:, None] < op.r2) & (hs[-1] == flat_out[row])
        delta = torch.where(sel, flat_g[row], 0.0)
        for li in range(len(tail_w) - 1, -1, -1):
            delta = torch.where(hs[li + 1] > 0, delta, 0.0)
            dw[li] += torch.matmul(hs[li].to(cd).float().t(), delta.to(cd).float())
            db[li] += delta.sum(0)
            delta = torch.matmul(delta.to(cd).float(), tail_w[li].t())
        d0 = torch.where(hs[0] > 0, delta, 0.0)
        da.index_put_((bi, j), d0, accumulate=True)
        dbc.index_put_((bi, pi), d0, accumulate=True)
    return da, dbc, dw, db


def _winner_grads(op: SAOperands, jstar: torch.Tensor, g: torch.Tensor):
    """Winner-only VJP (JAX ``ops/fused_sa.py::_winner_grads`` on the
    layer-1 split): gather each column's winning point, differentiate the
    float32 MLP (tail weights not rounded) at just those pairs, scatter the
    point cotangents back -> (da, dbc, dW_tail, db_tail)."""
    b, p, h3 = jstar.shape
    h1 = op.a.shape[-1]
    valid = jstar >= 0
    js = jstar.clamp(min=0).long().view(b, p * h3, 1)
    with torch.enable_grad():
        a_w = torch.gather(op.a.detach(), 1, js.expand(-1, -1, h1)).view(b, p, h3, h1).requires_grad_()
        bc = op.bc.detach().requires_grad_()
        ws = [w.detach().requires_grad_() for w in op.tail_w]
        bs = [x.detach().requires_grad_() for x in op.tail_b]
        h = torch.relu(a_w + bc[:, :, None, :])                     # (B, P, H3, H1)
        for w, bias in zip(ws[:-1], bs[:-1]):
            h = torch.relu(torch.matmul(h, w) + bias)
        y = torch.relu(torch.einsum("bpch,hc->bpc", h, ws[-1]) + bs[-1])
        grads = torch.autograd.grad(y, [a_w, bc, *ws, *bs], torch.where(valid, g, 0.0))
    da = gather_points_grad(grads[0].reshape(b, p * h3, h1), js.view(b, p * h3), op.a.shape[1])
    n_tail = len(ws)
    return da, grads[1], list(grads[2:2 + n_tail]), list(grads[2 + n_tail:])


# ---- kernel wrappers ----------------------------------------------------------

def _check_kernel_operands(name: str, op: SAOperands, active: Optional[torch.Tensor]):
    widths = (op.a.shape[-1], *(w.shape[1] for w in op.tail_w))
    if widths != KERNEL_WIDTHS:
        raise ValueError(f"{name} kernel: tail widths {widths} not compiled (only {KERNEL_WIDTHS})")
    if op.compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} kernel: unsupported compute dtype {op.compute_dtype}")
    b, n, _ = op.pts4.shape
    p = op.centers.shape[1]
    if active is None or active.shape != (b, -(-n // CHUNK), -(-p // TILE)):
        raise ValueError(f"{name} kernel: a culling bitmap of (B, ceil(N/CHUNK), ceil(P/TILE)) is required")
    check_cuda(name, op.pts4, op.a, op.centers, op.bc, *op.tail_w, *op.tail_b, op.r2)
    check_cuda(name, active, dtype=torch.uint8)
    return widths


def _kernel_args(op: SAOperands, active: torch.Tensor):
    """The pointers every fused kernel takes first, and the rounded tail
    weights they point at."""
    (w2, w3), (b2, b3) = _rounded_tail(op), op.tail_b
    return (op.pts4.data_ptr(), op.a.data_ptr(), op.centers.data_ptr(), op.bc.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), op.r2.data_ptr(),
            active.data_ptr()), (w2, w3)


def _kernel_tail(op: SAOperands, widths):
    b, n, _ = op.pts4.shape
    return (b, n, op.centers.shape[1], *widths, CHUNK, TILE, op.r2max,
            int(op.compute_dtype == torch.bfloat16))


def fused_sa_core(op: SAOperands, active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused forward on prepared operands -> (B, P, H3) float32.
    ``active`` is the culling bitmap (``cull_bitmap``) the kernel needs; the
    plain twin tests every pair and takes none."""
    if not op.pts4.is_cuda:
        return _fused_sa_plain(op)
    widths = _check_kernel_operands("fused_sa", op, active)
    out = torch.empty((*op.bc.shape[:2], widths[-1]), dtype=torch.float32, device=op.pts4.device)
    args, _ = _kernel_args(op, active)
    FUSED_SA_KERNEL.launch(op.pts4.device, *args, out.data_ptr(), *_kernel_tail(op, widths))
    return out


def fused_sa_argmax(op: SAOperands, active: Optional[torch.Tensor] = None):
    """The fused forward plus each column's winner -> (out (B, P, H3)
    float32, jstar (B, P, H3) int32): the flat point index of the column's
    maximum, the lowest index among equal maxima, -1 for an empty ball."""
    if not op.pts4.is_cuda:
        return _fused_sa_argmax_plain(op)
    widths = _check_kernel_operands("fused_sa_argmax", op, active)
    shape = (*op.bc.shape[:2], widths[-1])
    out = torch.empty(shape, dtype=torch.float32, device=op.pts4.device)
    jstar = torch.empty(shape, dtype=torch.int32, device=op.pts4.device)
    args, _ = _kernel_args(op, active)
    FUSED_SA_ARGMAX_KERNEL.launch(op.pts4.device, *args, out.data_ptr(), jstar.data_ptr(),
                                  *_kernel_tail(op, widths))
    return out, jstar


def da_scale(w2: torch.Tensor, w3: torch.Tensor, g: torch.Tensor, p: int) -> torch.Tensor:
    """Plain twin of B4's scale launch (csrc/fused_sa.cu ``da_scale_kernel``)
    -> int32 (2,): [S, flags].  S = 62 - e of the fixed-point da, where 2^e
    exceeds the bound 1.01 P G and G = max row sum |W2| x max row sum |W3| x
    max finite |g| bounds what one pair adds to a point (w2, w3 the rounded
    tail): a float64 product, summed along each row in order, so it cannot
    overflow and S may be negative.  Flags: ``DA_G_NONFINITE`` when g holds
    a NaN or inf (whose pairs the kernel flags one by one instead),
    ``DA_BOUND_NONFINITE`` when the bound is not finite (then S = 0 and all
    of da is NaN)."""
    finite = torch.isfinite(g)
    gmax = torch.where(finite, g.abs(), 0.0).amax().double()
    r2 = w2.double().abs().cumsum(1)[:, -1].amax()
    r3 = w3.double().abs().cumsum(1)[:, -1].amax()
    bound = r2 * r3 * gmax * (1.01 * p)
    ok = torch.isfinite(bound)
    flags = torch.where(finite.all(), 0, DA_G_NONFINITE) + torch.where(ok, 0, DA_BOUND_NONFINITE)
    s = torch.where(ok, 62 - torch.frexp(torch.where(ok, bound, 0.0)).exponent, 0)
    return torch.stack([s, flags]).to(torch.int32)


def _fused_sa_bwd_finish_plain(part: torch.Tensor, da_fx: torch.Tensor, da_state: torch.Tensor):
    dw3, dw2, db3, db2 = part.sum(0).split(PART_SPLIT)
    da = torch.ldexp(da_fx.double(), -da_state[0].double()).float()
    lanes = torch.arange(da.shape[-1], device=da.device)
    flagged = (da_state[DA_STATE_WORDS:].long()[:, None] >> lanes) & 1
    bad = flagged.bool().view(da.shape) | bool(da_state[1] & DA_BOUND_NONFINITE)
    da = torch.where(bad, float("nan"), da)
    h1, h2, h3 = KERNEL_WIDTHS
    return da, [dw2.view(h1, h2), dw3.view(h2, h3)], [db2, db3]


def fused_sa_bwd_finish(part: torch.Tensor, da_fx: torch.Tensor, da_state: torch.Tensor):
    """B4's second launch -> (da float32 shaped as da_fx, [dW2, dW3], [db2,
    db3]): ``part`` (rows, PART_WIDTH) summed over its rows in row order,
    ``da_fx`` (B, N, H1) int64 times 2^-S, with S, the flags and the
    per-point flag words from ``da_state`` (int32, DA_STATE_WORDS + B N):
    NaN where a flag bit is set, everywhere under DA_BOUND_NONFINITE."""
    h1, h2, h3 = KERNEL_WIDTHS
    if part.dim() != 2 or part.shape[1] != PART_WIDTH or da_fx.shape[-1] != h1 \
            or da_state.shape != (DA_STATE_WORDS + da_fx.numel() // h1,):
        raise ValueError(f"fused_sa_bwd_finish: expected part (rows, {PART_WIDTH}), da_fx (..., {h1}) and "
                         f"da_state ({DA_STATE_WORDS} + points,)")
    if not part.is_cuda:
        return _fused_sa_bwd_finish_plain(part, da_fx, da_state)
    check_cuda("fused_sa_bwd_finish", part)
    check_cuda("fused_sa_bwd_finish", da_fx, dtype=torch.int64)
    check_cuda("fused_sa_bwd_finish", da_state, dtype=torch.int32)
    da = torch.empty(da_fx.shape, dtype=torch.float32, device=part.device)
    dw2, dw3 = part.new_empty((h1, h2)), part.new_empty((h2, h3))
    db2, db3 = part.new_empty((h2,)), part.new_empty((h3,))
    FUSED_SA_BWD_FINISH_KERNEL.launch(part.device, part.data_ptr(), part.shape[0], da_fx.data_ptr(),
                                      da_state.data_ptr(), da_fx.numel(), da.data_ptr(), dw2.data_ptr(),
                                      db2.data_ptr(), dw3.data_ptr(), db3.data_ptr())
    return da, [dw2, dw3], [db2, db3]


def fused_sa_bwd(op: SAOperands, active: Optional[torch.Tensor], out: torch.Tensor, g: torch.Tensor):
    """Equality-select backward on prepared operands -> (da (B, N, H1), dbc
    (B, P, H1), [dW2, dW3], [db2, db3]), all float32.  ``out`` must be the
    forward's own output on the same operands, ``g`` its cotangent.  On the
    card: the kernel, then ``fused_sa_bwd_finish``; bit-equal from launch to
    launch."""
    if not op.pts4.is_cuda:
        return _fused_sa_bwd_plain(op, out, g)
    widths = _check_kernel_operands("fused_sa_bwd", op, active)
    if out.shape != (*op.bc.shape[:2], widths[-1]) or g.shape != out.shape:
        raise ValueError("fused_sa_bwd: out and g must be (B, P, H3)")
    check_cuda("fused_sa_bwd", out, g)
    dbc, part, da_fx, da_state = _bwd_first_launch(op, active, out, g, widths)
    da, dw, db = fused_sa_bwd_finish(part, da_fx, da_state)
    return da, dbc, dw, db


def _bwd_first_launch(op: SAOperands, active: torch.Tensor, out: torch.Tensor, g: torch.Tensor, widths):
    """B4's first launch (the scale, then the backward) -> (dbc, its dW / db
    workspace, da in fixed point, the fixed-point state: S, the flags and
    the per-point flag words): what ``fused_sa_bwd_finish`` takes."""
    args, _ = _kernel_args(op, active)
    b, n = op.a.shape[:2]
    p = op.bc.shape[1]
    da_state = torch.zeros(DA_STATE_WORDS + b * n, dtype=torch.int32, device=op.a.device)
    da_fx = torch.zeros(op.a.shape, dtype=torch.int64, device=op.a.device)
    dbc = torch.empty_like(op.bc)
    part = torch.empty((b * -(-p // TILE), PART_WIDTH), dtype=torch.float32, device=op.a.device)
    FUSED_SA_BWD_KERNEL.launch(
        op.pts4.device, *args, out.data_ptr(), g.data_ptr(), da_state.data_ptr(), da_fx.data_ptr(),
        dbc.data_ptr(), part.data_ptr(), *_kernel_tail(op, widths))
    return dbc, part, da_fx, da_state


class _FusedSA(torch.autograd.Function):
    """out = fused forward(a, bc, tail); the backward is ``fused_sa_bwd``
    ("kernel") or ``_winner_grads`` at the forward's recorded winners
    ("argmax").  Saves the forward's own output: equality-select needs
    exactly that tensor."""

    @staticmethod
    def forward(ctx, op, active, backward, a, bc, *tail):
        n_tail = len(tail) // 2
        op = op._replace(a=a, bc=bc, tail_w=list(tail[:n_tail]), tail_b=list(tail[n_tail:]))
        if backward == "argmax":
            out, aux = fused_sa_argmax(op, active)
        else:
            out = aux = fused_sa_core(op, active)
        ctx.backward, ctx.active, ctx.n_tail = backward, active, n_tail
        ctx.op = op._replace(a=None, bc=None, tail_w=None, tail_b=None)
        ctx.save_for_backward(a, bc, *tail, aux)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, bc, *tail, aux = ctx.saved_tensors
        n_tail = ctx.n_tail
        op = ctx.op._replace(a=a, bc=bc, tail_w=tail[:n_tail], tail_b=tail[n_tail:])
        g = g.float().contiguous()
        if ctx.backward == "argmax":
            da, dbc, dw, db = _winner_grads(op, aux, g)
        else:
            da, dbc, dw, db = fused_sa_bwd(op, ctx.active, aux, g)
        return (None, None, None, da, dbc, *dw, *db)


def ball_mlp_max(xyz: torch.Tensor, centers: torch.Tensor, weights, biases, radius,
                 features: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                 compute_dtype=torch.bfloat16, backward: str = "kernel") -> torch.Tensor:
    """Fused radius-neighbourhood PointNet scale (differentiable).

    xyz (B, N, 3) float32, centers (B, P, 3), weights/biases per layer in
    (in, out) layout, radius a float or one per output column, optional
    features (B, N, F) and validity mask (B, N) -> (B, P, H_last) float32.
    On the card: the culling pre-pass kernel (it writes the bitmap too), then
    the fused kernel (its argmax variant under ``backward="argmax"``) and, in
    the backward, ``fused_sa_bwd``; on the CPU: the plain twins.  Centres
    are treated as constants of the ball (no gradient flows through the
    radius test); their layer-1 term does get its gradient.
    """
    if backward not in BACKWARDS:
        raise ValueError(f"ball_mlp_max: backward must be one of {BACKWARDS}, got {backward!r}")
    op = prepare(xyz, centers, weights, biases, radius, features, mask, compute_dtype)
    active = block_min_d2_and_cull(op.pts4, op.centers, op.r2max)[1] if op.pts4.is_cuda else None
    return _FusedSA.apply(op, active, backward, op.a, op.bc, *op.tail_w, *op.tail_b)
