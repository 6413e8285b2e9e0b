"""Least device time of a kernel's work, counted from the inputs and the
configuration's widths, never from the program's own operands.

Each count is of what the algorithm needs for these inputs: every input
byte read once and every output byte written once, and the operations the
data asks for (the in-radius pairs of each ball under the reference's own
centres, the points FPS scans).  The least time is the larger of operations
over the peak of the unit that runs them and bytes over HBM bandwidth.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..reference import ops
from .flops import PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_HBM_BYTES

FPS_FLOPS_PER_POINT = 9  # a squared distance (3 sub, 3 mul, 2 add) and a running min


def least_seconds(flops: float, peak_flops: float, nbytes: float) -> float:
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES)


def stacked_clouds(batch, device) -> Dict[str, torch.Tensor]:
    """A training batch as the model encodes it: templates then sources,
    one stack of 2B clouds, each moved by its augmentation."""
    pts = torch.cat([torch.as_tensor(batch["template"]), torch.as_tensor(batch["source"])]).to(device)
    mask = torch.cat([torch.as_tensor(batch["template_mask"]), torch.as_tensor(batch["source_mask"])]).to(device)
    aug = torch.cat([torch.as_tensor(batch["aug_template"]), torch.as_tensor(batch["aug_source"])]).to(device)
    xyz = torch.matmul(pts[..., :3], aug[..., :3, :3].transpose(-1, -2)) + aug[..., None, :3, 3]
    return {"xyz": xyz, "mask": mask}


def ball_pairs(model_cfg, xyz: torch.Tensor, mask: torch.Tensor) -> List[int]:
    """In-radius (centre, point) pairs of each scale of the first stage,
    summed over the clouds, under the reference's FPS centres."""
    sa = model_cfg["params"]["cloud_features"]["params"]
    if xyz.shape[1] >= ops.SORT_MIN_POINTS:
        xyz, _, mask = ops.morton_sort(xyz, None, mask)
    idx = ops.fps(xyz, int(sa["npoint"][0]), mask)
    centres = torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3))
    counts = [0] * len(sa["radii"][0])
    for b in range(xyz.shape[0]):
        d2 = ops.sq_dist(xyz[b][None, :, :], centres[b][:, None, :])
        for s, radius in enumerate(sa["radii"][0]):
            r2 = torch.tensor(float(radius), dtype=torch.float32, device=xyz.device) ** 2
            counts[s] += int(((d2 < r2) & mask[b][None, :]).sum())
    return counts


def fps_least(model_cfg, clouds: int, points: int) -> float:
    """FPS over ``clouds`` clouds of ``points`` points: every iteration
    after the first scans every point once."""
    npoint = int(model_cfg["params"]["cloud_features"]["params"]["npoint"][0])
    flops = clouds * (npoint - 1) * points * FPS_FLOPS_PER_POINT
    nbytes = clouds * points * (12 + 1) + clouds * npoint * 4
    return least_seconds(flops, PEAK_FP32_FLOPS, nbytes)


def fused_sa_bwd_least(model_cfg, clouds: int, points: int, pairs: List[int]) -> float:
    """The backward of the fused ball-MLP-max of the first stage: recompute
    every in-radius pair's tail (layers 2 on, bf16 products) to find the
    rows that reach the max; read the points, the layer-1 point and centre
    terms, the output and its cotangent and the tail weights once; write
    the layer-1 gradients and the tail weights' gradients once."""
    sa = model_cfg["params"]["cloud_features"]["params"]
    npoint = int(sa["npoint"][0])
    mlps = sa["mlps"][0]
    h1 = sum(m[0] for m in mlps)
    h3 = sum(m[-1] for m in mlps)
    tail = sum(sum(m[i] * m[i + 1] + m[i + 1] for i in range(len(m) - 1)) for m in mlps)
    flops = sum(n * 2 * sum(m[i] * m[i + 1] for i in range(len(m) - 1)) for n, m in zip(pairs, mlps))
    read = clouds * (points * (12 + 1) + points * h1 * 4 + npoint * (3 + h1 + 2 * h3) * 4) + tail * 4
    written = clouds * (points + npoint) * h1 * 4 + tail * 4
    return least_seconds(flops, PEAK_BF16_FLOPS, read + written)
