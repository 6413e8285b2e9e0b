"""KITTI odometry benchmark evaluation: ``eval(gt_dir, pred_dir,
result_dir=None)`` runs the native evaluator (``deepclr_tpu_torch.native``
builds it from ``csrc/host/kitti_devkit.cpp``); ``python -m deepclr_tpu_torch.kitti_devkit``
also draws the plots when matplotlib imports."""
from ..native import kitti_devkit_eval as eval  # noqa: A001 (the devkit's name)

__all__ = ["eval"]
