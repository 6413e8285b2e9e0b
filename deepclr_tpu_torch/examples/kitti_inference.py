"""Minimal sequential-inference demo on raw KITTI odometry data
(scripts/examples/kitti_inference.py):

    KITTI_PATH=DIR MODEL_PATH=MODELS python -m deepclr_tpu_torch.examples.kitti_inference \
        MODEL_NAME [--sequence 04] [--num_frames 10] [--device cuda]

registers every 2nd point of each velodyne frame of DIR/original against the
previous frame (16384 points a cloud) and prints the translation error
against the ground truth.  On the card the encoder runs the FPS, culling
and fused set-abstraction kernels; ``--device cpu`` runs their plain twins.
"""
import argparse
import os
import os.path as osp

import numpy as np

from ..data.readers import KittiOdometryVelodyneData
from ..geometry.hostmath import label_to_matrix_np
from ..models import ModelInferenceHelper
from ._model import load_demo_model


def main():
    parser = argparse.ArgumentParser(description="Sequential model inference for raw KITTI data.")
    parser.add_argument("model_name", type=str, help="Model name (directory in MODEL_PATH)")
    parser.add_argument("--sequence", type=str, default="04")
    parser.add_argument("--num_frames", type=int, default=10)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()

    kitti_path = os.getenv("KITTI_PATH")
    if kitti_path is None:
        raise RuntimeError("Could not get KITTI path from environment variable KITTI_PATH.")
    model_path = os.getenv("MODEL_PATH")
    if model_path is None:
        raise RuntimeError("Could not get model path from environment variable MODEL_PATH.")

    model_cfg, model = load_demo_model(osp.join(model_path, args.model_name), args.device)
    helper = ModelInferenceHelper(model, is_sequential=True, num_points=16384)

    df = KittiOdometryVelodyneData(osp.join(kitti_path, "original"), args.sequence, shuffle=False)

    prev = None
    for i, frame in enumerate(df):
        if i >= args.num_frames:
            break
        cloud = frame["cloud"][::2]  # every 2nd point, like the converter
        y_pred = helper.predict(cloud)
        if y_pred is None:
            prev = frame
            continue
        m_pred = label_to_matrix_np(model_cfg.label_type, y_pred)
        if prev is not None:
            m_gt = np.linalg.inv(prev["pose"]) @ frame["pose"]
            t_err = np.linalg.norm(m_pred[:3, 3] - m_gt[:3, 3])
            print(f"frame {i}: translation error {t_err:.4f} m")
        prev = frame


if __name__ == "__main__":
    main()
