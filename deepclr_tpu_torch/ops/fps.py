"""Furthest point sampling (FPS) on fixed-shape, masked point clouds.

Start at the lowest valid index (0 when the cloud has none), then repeatedly
pick the point with the largest running min squared distance to the picked
set; ties go to the lowest index.  Invalid points keep a running distance of
-1, so they are never picked while a valid point remains; if ``npoint``
exceeds the valid count, picks repeat.

``furthest_point_sample`` launches the CUDA kernel ``csrc/fps.cu`` on a CUDA
tensor and runs ``_fps_plain`` on a CPU tensor; both give the same indices,
bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._cuda import CudaKernel, check_cuda

__all__ = ["furthest_point_sample", "FPS_KERNEL", "FPS_MAX_POINTS"]

FPS_KERNEL = CudaKernel(
    "fps", "fps", "deepclr_fps",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int],
)
# the kernel keeps a cloud's coordinates in shared memory and 16 running
# distances per thread in registers: 1024 threads x 16 points
FPS_MAX_POINTS = 16384


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


def _fps_cuda(xyz: torch.Tensor, npoint: int, mask: torch.Tensor) -> torch.Tensor:
    b, n, _ = xyz.shape
    if n > FPS_MAX_POINTS:
        raise ValueError(f"fps kernel: N={n} exceeds {FPS_MAX_POINTS} points per cloud")
    mask_u8 = mask.to(torch.uint8).contiguous()
    check_cuda("fps", xyz)
    check_cuda("fps", mask_u8, dtype=torch.uint8)
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    FPS_KERNEL.launch(xyz.device, xyz.data_ptr(), mask_u8.data_ptr(), out.data_ptr(), b, n, npoint)
    return out


def furthest_point_sample(xyz: torch.Tensor, npoint: int,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, 3) float32 [+ (B, N) bool mask] -> (B, npoint) int32 indices."""
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"furthest_point_sample: xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    if xyz.dtype != torch.float32:
        raise ValueError(f"furthest_point_sample: xyz must be float32, got {xyz.dtype}")
    xyz = xyz.contiguous()
    if mask is None:
        mask = torch.ones(xyz.shape[:2], dtype=torch.bool, device=xyz.device)
    if xyz.is_cuda:
        return _fps_cuda(xyz, npoint, mask)
    return _fps_plain(xyz, npoint, mask)
