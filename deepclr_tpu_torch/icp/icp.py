"""Classic ICP registration baselines on torch tensors.

Three variants, each iterating until the largest entry of the transform's
update falls below ``epsilon`` or ``max_iterations`` is reached, with
correspondences gated by ``max_distance``:

  * ICP_PO2PO — point-to-point: nearest-neighbour correspondences and a
    weighted Kabsch (SVD) update;
  * ICP_PO2PL — point-to-plane: template normals from the k-NN covariance's
    smallest eigenvector, a linearised 6-DoF Gauss-Newton step;
  * GICP      — Segal's generalised (plane-to-plane) ICP: per-point
    covariances with eigenvalues flattened to (eps, 1, 1), a
    Mahalanobis-weighted Gauss-Newton step.

``register(template, source)`` returns the 4x4 float32 transform mapping
source into the template frame; ``return_info=True`` adds the iteration
count, the final update and the time spent in the per-iteration host reads
of the convergence test.

Clouds are registered at their own size, without padding.  Nearest
neighbours are searched one block of queries at a time (``knn_block_size``),
so no N x N distance matrix is ever held: a ~60000-point scan against
another needs one (block, N) matrix at a time.  Everything is float32 with
TF32 off.  Distances and moved points are sums of rounded products in a
fixed order, one elementwise op each (no matmul, so no device-dependent
order or FMA): the card and the CPU pick the same neighbours for the same
points, which decides every later iteration.  The linear algebra uses the
``*_ex`` variants, which report a failed factorisation instead of raising,
and a failed matrix gives what the LAPACK-style reference gives (NaN
through ``solve``, a zero whitening factor in GICP).
"""
from __future__ import annotations

import enum
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device, strict_float32

__all__ = ["ICPAlgorithm", "ICPRegistration", "estimate_covariances", "estimate_normals", "knn_block_size",
           "nearest_neighbors"]

_FLT_MAX = float(np.finfo(np.float32).max)
# bytes of scratch the neighbour search may hold for one block of queries:
# at ~60000 reference points about 1100 queries a block
KNN_BLOCK_BYTES = 1 << 31
# bytes a (query, reference) entry takes at the search's peak: the float32
# distances and their temporaries, and the int64 keys of k > 1
_BYTES_PER_ENTRY = 32
# the batched 3x3 linear algebra runs on slices of this many matrices:
# cuSOLVER's batched eigensolver rejects a scan's ~60000 at once
# (CUSOLVER_STATUS_INVALID_VALUE on the H100, torch 2.11 / CUDA 12.8)
# and takes 4096
_LINALG_BATCH = 4096


class ICPAlgorithm(enum.Enum):
    ICP_PO2PO = "icp_po2po"
    ICP_PO2PL = "icp_po2pl"
    GICP = "gicp"

    @classmethod
    def create(cls, value) -> "ICPAlgorithm":
        if isinstance(value, cls):
            return value
        return cls(str(value).lower())


def knn_block_size(n_points: int) -> int:
    """Queries a block of the neighbour search against ``n_points``
    reference points, from the scratch budget ``KNN_BLOCK_BYTES``."""
    return max(1, KNN_BLOCK_BYTES // (max(1, n_points) * _BYTES_PER_ENTRY))


def _sqdist(query: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(Q, N) squared distances as the per-axis squared differences summed
    x, y, z.  Unlike ||q||^2 + ||p||^2 - 2 q.p (``ops.pairwise_sqdist``), no
    term cancels: at scan scale (~80 m) that form is off by ~5e-4 m^2, which
    decides near-ties and the gate at random."""
    d2 = (query[:, None, 0] - points[None, :, 0]).square_()
    for c in range(1, query.shape[1]):
        d2.add_((query[:, None, c] - points[None, :, c]).square_())
    return d2


def _rigid(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The 4x4 transform of R and t, built on their device (a bottom row
    made from host data would be a copy that waits for the device)."""
    out = torch.eye(4, dtype=rot.dtype, device=rot.device)
    out[:3, :3] = rot
    out[:3, 3] = t
    return out


def _transform_points(transform: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """R p + t for (N, 3) points, summed left to right as separate
    elementwise ops."""
    rot, out = transform[:3, :3], transform[:3, 3]
    for c in range(3):
        out = out + pts[:, c:c + 1] * rot[:, c]
    return out


def nearest_neighbors(query: torch.Tensor, points: torch.Tensor, k: int,
                      points_mask: Optional[torch.Tensor] = None, block: Optional[int] = None):
    """The k nearest reference points of every query point, nearest first.

    query (Q, 3), points (N, 3), points_mask (N,) bool or None -> (idx (Q, k)
    int64, sqdist (Q, k) float32), distances by ``_sqdist``; masked points
    count as float32-max away, so they are never chosen while k
    valid points exist.  Ties go to the lowest index: k = 1 takes ``min``
    over the row (the first minimum), k > 1 ranks unique int64 keys (the
    distance's bits, then the index) with ``topk``, whose own tie order is
    left open.  The queries run ``block`` at a time (default
    ``knn_block_size(N)``), so at most a (block, N) matrix is held.
    """
    n = points.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} needs 1 <= k <= {n} reference points")
    block = block or knn_block_size(n)
    shift = max(1, (n - 1).bit_length())
    iota = torch.arange(n, device=points.device)
    idx_out = torch.empty((query.shape[0], k), dtype=torch.int64, device=query.device)
    d2_out = torch.empty((query.shape[0], k), dtype=torch.float32, device=query.device)
    for lo in range(0, query.shape[0], block):
        d2 = _sqdist(query[lo:lo + block], points)
        if points_mask is not None:
            d2 = torch.where(points_mask[None, :], d2, _FLT_MAX)
        if k == 1:
            d2_min, idx = d2.min(dim=-1, keepdim=True)
            idx_out[lo:lo + block], d2_out[lo:lo + block] = idx, d2_min
            continue
        # non-negative float32 bits order as the values do
        key = (d2.view(torch.int32).to(torch.int64) << shift) | iota
        del d2
        key = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
        idx_out[lo:lo + block] = key & ((1 << shift) - 1)
        d2_out[lo:lo + block] = (key >> shift).to(torch.int32).view(torch.float32)
    return idx_out, d2_out


def _batched(fn, x: torch.Tensor):
    """``fn`` (a torch.linalg function of a batch of matrices returning a
    tuple) on slices of ``_LINALG_BATCH`` matrices, the results joined."""
    parts = [fn(x[i:i + _LINALG_BATCH]) for i in range(0, x.shape[0], _LINALG_BATCH)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _neighborhood_cov(points: torch.Tensor, k: int, block: Optional[int]) -> torch.Tensor:
    """k-NN covariance matrices per point (N, 3, 3)."""
    idx, _ = nearest_neighbors(points, points, k, block=block)
    nbrs = points[idx]                                    # (N, k, 3)
    centered = nbrs - nbrs.mean(dim=1, keepdim=True)
    return centered.transpose(1, 2) @ centered / k


def estimate_normals(points: torch.Tensor, k: int = 30, block: Optional[int] = None) -> torch.Tensor:
    """Per-point normals (N, 3): the smallest eigenvector of the k-NN
    covariance (the sign is the solver's)."""
    _, vecs = _batched(torch.linalg.eigh, _neighborhood_cov(points, k, block))  # ascending eigenvalues
    return vecs[:, :, 0]


def estimate_covariances(points: torch.Tensor, k: int = 20, epsilon: float = 1e-3,
                         block: Optional[int] = None) -> torch.Tensor:
    """GICP covariances (N, 3, 3): the k-NN covariance's eigenvalues flattened
    to (epsilon, 1, 1)."""
    _, vecs = _batched(torch.linalg.eigh, _neighborhood_cov(points, k, block))
    lam = torch.ones(3, dtype=points.dtype, device=points.device)
    lam[0] = epsilon
    return (vecs * lam) @ vecs.transpose(1, 2)


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def _se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exponential, xi = [omega(3), v(3)] -> 4x4."""
    omega, v = xi[:3], xi[3:]
    theta = torch.linalg.vector_norm(omega) + 1e-12
    kk = _skew(omega / theta)
    kk2 = kk @ kk
    s, c = torch.sin(theta), torch.cos(theta)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    rot = eye + s * kk + (1 - c) * kk2
    vmat = eye + (1 - c) / theta * kk + (theta - s) / theta * kk2
    return _rigid(rot, vmat @ v)


def _correspondences(src, template, max_distance):
    idx, d2 = nearest_neighbors(src, template, 1)
    idx, d2 = idx[:, 0], d2[:, 0]
    return template[idx], idx, (d2 < max_distance * max_distance).float()


def _po2po_step(src0, template, transform, max_distance):
    src = _transform_points(transform, src0)
    tgt, _, w = _correspondences(src, template, max_distance)
    wsum = w.sum() + 1e-8
    cs = (src * w[:, None]).sum(dim=0) / wsum
    ct = (tgt * w[:, None]).sum(dim=0) / wsum
    h = ((src - cs) * w[:, None]).T @ (tgt - ct)
    u, _, vt = torch.linalg.svd(h)
    d = torch.sign(torch.linalg.det(vt.T @ u.T))
    diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d])
    rot = vt.T @ torch.diag(diag) @ u.T
    return _rigid(rot, ct - rot @ cs) @ transform


def _gauss_newton_step(src0, template, transform, max_distance, weight_fn):
    """Minimise sum w * ||L_i (R s + t - q_i)||^2, linearised at the identity."""
    src = _transform_points(transform, src0)
    tgt, idx, w = _correspondences(src, template, max_distance)
    lw = weight_fn(idx, transform)                        # (N, 3, 3)
    d = src - tgt                                         # the residual before the increment
    # Jacobian of (R_inc s' + t_inc - q) in xi = [omega, v] at the identity
    jac = torch.cat([-_skew(src), torch.eye(3, dtype=src.dtype, device=src.device).expand(src.shape[0], 3, 3)],
                    dim=-1)                               # (N, 3, 6)
    lj = lw @ jac                                         # (N, 3, 6)
    ld = (lw @ d[:, :, None])[:, :, 0]                    # (N, 3)
    wlj = (lj * w[:, None, None]).reshape(-1, 6)
    a = wlj.T @ lj.reshape(-1, 6)                         # sum_n w_n (L_n J_n)^T (L_n J_n)
    b = wlj.T @ ld.reshape(-1)                            # sum_n w_n (L_n J_n)^T (L_n d_n)
    xi, info = torch.linalg.solve_ex(a + 1e-6 * torch.eye(6, dtype=a.dtype, device=a.device), b)
    xi = torch.where(info == 0, -xi, float("nan"))        # a singular system gives NaN, as LU does
    return _se3_exp(xi) @ transform


def _gicp_whitening(cov_t: torch.Tensor, cov_s: torch.Tensor):
    """The GICP weight: L with ||L d||^2 = d^T (C_t[idx] + R C_s R^T)^-1 d."""
    eye = torch.eye(3, dtype=cov_t.dtype, device=cov_t.device)

    def weight_fn(idx, transform):
        rot = transform[:3, :3]
        m = cov_t[idx] + rot @ cov_s @ rot.T
        # rounding can leave a flattened covariance slightly indefinite:
        # symmetrise and add jitter; a matrix whose inverse or Cholesky
        # factor fails gets a zero factor (LAPACK's NaN triangle, zeroed), so
        # no NaN reaches the normal equations through 0 * NaN
        m = 0.5 * (m + m.transpose(-1, -2)) + 1e-5 * eye
        inv, inv_info = _batched(torch.linalg.inv_ex, m)
        chol, chol_info = _batched(torch.linalg.cholesky_ex, inv)
        lw = chol.transpose(-1, -2)
        failed = (inv_info != 0) | (chol_info != 0)
        lw = torch.where(failed[:, None, None], 0.0, lw)
        return torch.where(torch.isfinite(lw), lw, 0.0)

    return weight_fn


class ICPRegistration:
    """Prepare and register point clouds with one ICP variant, on ``device``
    (the card unless the caller asks for the CPU)."""

    def __init__(self, algorithm: ICPAlgorithm, max_distance: float = 1.0, neighbor_radius: float = 1.0,
                 max_nn: int = 30, max_iterations: int = 100, epsilon: float = 1e-3, device="cuda"):
        self._algorithm = ICPAlgorithm.create(algorithm)
        self._max_distance = float(max_distance)
        self._neighbor_radius = neighbor_radius
        self._max_nn = int(max_nn)
        self._max_iterations = int(max_iterations)
        self._epsilon = float(epsilon)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            strict_float32()

    def prepare(self, cloud) -> Dict[str, torch.Tensor]:
        """Upload an (N, >=3) cloud and compute what its variant needs of it
        (normals for po2pl, covariances for GICP)."""
        pts = torch.as_tensor(np.asarray(cloud, np.float32)[:, :3]).to(self.device)
        prepared = {"points": pts}
        if self._algorithm == ICPAlgorithm.ICP_PO2PL:
            prepared["normals"] = estimate_normals(pts, k=self._max_nn)
        elif self._algorithm == ICPAlgorithm.GICP:
            prepared["cov"] = estimate_covariances(pts, k=min(self._max_nn, 20))
        return prepared

    def _step_fn(self, template: Dict[str, Any], source: Dict[str, Any]):
        src, tpl, dist = source["points"], template["points"], self._max_distance
        if self._algorithm == ICPAlgorithm.ICP_PO2PO:
            return lambda transform: _po2po_step(src, tpl, transform, dist)
        if self._algorithm == ICPAlgorithm.ICP_PO2PL:
            normals = template["normals"]

            def weight_fn(idx, transform):
                n = normals[idx]
                return n[:, :, None] * n[:, None, :]      # rank-1 L = n n^T
        else:
            weight_fn = _gicp_whitening(template["cov"], source["cov"])
        return lambda transform: _gauss_newton_step(src, tpl, transform, dist, weight_fn)

    def register(self, template: Dict[str, Any], source: Dict[str, Any], return_info: bool = False):
        """4x4 float32 transform aligning source onto template; with
        ``return_info`` also {iterations, final_delta, loop_ms,
        host_read_ms, device_ms}.

        The loop reads the update's size back each iteration to test
        convergence.  ``loop_ms`` is the loop's host time, ``host_read_ms``
        the part blocked in those reads (waiting for the iteration's device
        work), and ``device_ms`` (on the card; None on the CPU) the sum of
        each iteration's device span, from CUDA events around it: the rest
        of ``loop_ms`` the device spends waiting for the host between
        iterations.
        """
        step = self._step_fn(template, source)
        transform = torch.eye(4, dtype=torch.float32, device=self.device)
        iterations, delta, read_s, spans = 0, float("inf"), 0.0, []
        timed = self.device.type == "cuda"
        loop_start = time.perf_counter()
        # a NaN update fails `delta >= epsilon` and stops the loop, as the
        # reference's while-loop condition does
        while iterations < self._max_iterations and delta >= self._epsilon:
            if timed:
                spans.append((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
                spans[-1][0].record()
            new = step(transform)
            change = (new - transform).abs().max()
            if timed:
                spans[-1][1].record()
            t0 = time.perf_counter()
            delta = change.item()
            read_s += time.perf_counter() - t0
            transform = new
            iterations += 1
        loop_ms = (time.perf_counter() - loop_start) * 1e3
        m = transform.cpu().numpy()
        if return_info:
            return m, {"iterations": iterations, "final_delta": delta, "loop_ms": loop_ms,
                       "host_read_ms": read_s * 1e3,
                       "device_ms": sum(a.elapsed_time(b) for a, b in spans) if timed else None}
        return m
