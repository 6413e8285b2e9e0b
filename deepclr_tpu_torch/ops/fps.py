"""Furthest point sampling (FPS) on fixed-shape, masked point clouds.

Start at the lowest valid index (0 when the cloud has none), then repeatedly
pick the point with the largest running min squared distance to the picked
set; ties go to the lowest index.  Invalid points keep a running distance of
-1, so they are never picked while a valid point remains; if ``npoint``
exceeds the valid count, picks repeat.

``furthest_point_sample`` launches the CUDA kernel ``csrc/fps.cu`` on a CUDA
tensor and runs ``_fps_plain`` on a CPU tensor; both give the same indices,
bit for bit.  The kernel spreads each cloud over a thread-block cluster of
``cluster`` CTAs, each owning a contiguous range of the cloud's indices;
``cluster_size`` picks that size from (B, N).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from ._cuda import CudaKernel, c_function, check_cuda

__all__ = ["furthest_point_sample", "cluster_size", "device_cluster_size", "FPS_KERNEL", "FPS_MAX_POINTS",
           "CLUSTER_SIZES"]

FPS_KERNEL = CudaKernel(
    "fps", "fps", "deepclr_fps",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int],
)
CLUSTER_SIZES = (1, 2, 4, 8, 16)   # 16 is a non-portable cluster size on Hopper
MAX_POINTS_PER_CTA = 16384         # 1024 threads x 16 running distances in registers
FPS_MAX_POINTS = CLUSTER_SIZES[-1] * MAX_POINTS_PER_CTA

_fits_cache: Dict[Tuple[int, int, int], int] = {}


def _fps_plain(xyz: torch.Tensor, npoint: int, mask: torch.Tensor) -> torch.Tensor:
    """Reference loop: (B, N, 3) float32, (B, N) bool -> (B, npoint) int32."""
    b = xyz.shape[0]
    rows = torch.arange(b, device=xyz.device)
    dists = torch.where(mask, 1e10, -1.0).to(torch.float32)
    idx = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    idx[:, 0] = torch.argmax(mask.to(torch.int8), dim=1)  # first max: lowest valid
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    for i in range(1, npoint):
        c = xyz[rows, idx[:, i - 1]]
        dx = x - c[:, 0:1]
        dy = y - c[:, 1:2]
        dz = z - c[:, 2:3]
        d = dx * dx + dy * dy + dz * dz
        dists = torch.minimum(dists, torch.where(mask, d, -1.0))
        idx[:, i] = torch.argmax(dists, dim=1)  # first max: lowest index
    return idx.to(torch.int32)


def cluster_size(b: int, n: int, capacity: Callable[[int], int]) -> int:
    """The rule for the kernel's cluster size C: the largest power of two
    <= 16 such that the B clusters of C CTAs of an N-point cloud are
    resident on the card at once.  ``capacity(c)`` is how many such
    clusters the card holds at once (``device_cluster_size`` asks
    ``cudaOccupancyMaxActiveClusters``).  A cloud too large for a smaller
    cluster forces the smallest that holds it."""
    need = next((c for c in CLUSTER_SIZES if c * MAX_POINTS_PER_CTA >= n), None)
    if need is None:
        raise ValueError(f"fps kernel: N={n} exceeds {FPS_MAX_POINTS} points per cloud")
    return next((c for c in reversed(CLUSTER_SIZES) if c > need and capacity(c) >= b), need)


def _max_active_clusters(device: torch.device, n: int, c: int) -> int:
    key = (device.index if device.index is not None else torch.cuda.current_device(), n, c)
    if key not in _fits_cache:
        fn = c_function("fps", "deepclr_fps_max_active_clusters",
                        [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
        clusters = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = fn(n, c, ctypes.byref(clusters))
        if err != 0:
            raise RuntimeError(f"fps: cudaOccupancyMaxActiveClusters failed with cudaError {err} (C={c})")
        _fits_cache[key] = clusters.value
    return _fits_cache[key]


def device_cluster_size(device: torch.device, b: int, n: int) -> int:
    """``cluster_size`` on the card of ``device``, with its occupancy answer."""
    return cluster_size(b, n, lambda c: _max_active_clusters(device, n, c))


def _check_cluster(n: int, cluster: int) -> None:
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"fps kernel: cluster size {cluster} is not one of {CLUSTER_SIZES}")
    if n > cluster * MAX_POINTS_PER_CTA:
        raise ValueError(f"fps kernel: N={n} exceeds {cluster * MAX_POINTS_PER_CTA} points per cloud "
                         f"at cluster size {cluster}")


def _fps_cuda(xyz: torch.Tensor, npoint: int, mask: torch.Tensor, cluster: Optional[int]) -> torch.Tensor:
    b, n, _ = xyz.shape
    if cluster is None:
        cluster = device_cluster_size(xyz.device, b, n)
    mask_u8 = mask.to(torch.uint8).contiguous()
    check_cuda("fps", xyz)
    check_cuda("fps", mask_u8, dtype=torch.uint8)
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    FPS_KERNEL.launch(xyz.device, xyz.data_ptr(), mask_u8.data_ptr(), out.data_ptr(), b, n, npoint, cluster)
    return out


def furthest_point_sample(xyz: torch.Tensor, npoint: int, mask: Optional[torch.Tensor] = None,
                          cluster: Optional[int] = None) -> torch.Tensor:
    """(B, N, 3) float32 [+ (B, N) bool mask] -> (B, npoint) int32 indices.

    ``cluster``: the kernel's CTAs per cloud (1, 2, 4, 8 or 16), by default
    ``cluster_size``'s choice on this card.  The indices do not depend on
    it; the plain version, which a CPU tensor runs, takes none."""
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"furthest_point_sample: xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    if xyz.dtype != torch.float32:
        raise ValueError(f"furthest_point_sample: xyz must be float32, got {xyz.dtype}")
    if cluster is not None:
        _check_cluster(xyz.shape[1], cluster)
    xyz = xyz.contiguous()
    if mask is None:
        mask = torch.ones(xyz.shape[:2], dtype=torch.bool, device=xyz.device)
    if xyz.is_cuda:
        return _fps_cuda(xyz, npoint, mask, cluster)
    return _fps_plain(xyz, npoint, mask)
