"""Point-cloud ops of the port.  Every op is batched, fixed-shape and
mask-aware, takes and returns torch tensors, and runs on the tensor's
device: the hand-written CUDA kernels (FPS, the culling pre-pass, the fused
set abstraction, the gathers' backward) on a CUDA tensor, their plain
PyTorch twins on a CPU one.  Ball query, kNN, the gathers' forward and the
interpolation are plain PyTorch on both, as the JAX package leaves them to
XLA."""
from ._cuda import build_all, launch_counts, reset_launch_counts
from .ball_grouping import ball_query, ball_query_scales
from .fps import furthest_point_sample
from .fused_sa import ball_mlp_max, multi_scale_bundle
from .grouping import gather_points, gather_points_grad, group_points
from .interpolate import three_interpolate, three_interpolate_weights, three_nn
from .knn import knn
from .morton import morton_argsort_np, morton_code, spatial_sort
from .pairwise import pairwise_sqdist

__all__ = [
    "ball_mlp_max",
    "ball_query",
    "ball_query_scales",
    "build_all",
    "furthest_point_sample",
    "gather_points",
    "gather_points_grad",
    "group_points",
    "knn",
    "launch_counts",
    "morton_argsort_np",
    "morton_code",
    "multi_scale_bundle",
    "pairwise_sqdist",
    "reset_launch_counts",
    "spatial_sort",
    "three_interpolate",
    "three_interpolate_weights",
    "three_nn",
]
