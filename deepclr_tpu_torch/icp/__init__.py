"""Classic ICP baselines (point-to-point, point-to-plane, GICP) on torch
tensors; ``python -m deepclr_tpu_torch.icp`` registers a scenario with them."""
from .icp import (
    ICPAlgorithm,
    ICPRegistration,
    estimate_covariances,
    estimate_normals,
    knn_block_size,
    nearest_neighbors,
)

__all__ = [
    "ICPAlgorithm",
    "ICPRegistration",
    "estimate_normals",
    "estimate_covariances",
    "knn_block_size",
    "nearest_neighbors",
]
