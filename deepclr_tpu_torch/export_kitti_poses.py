"""Export predicted velodyne-frame poses as KITTI cam0-frame pose files
(scripts/export_kitti_poses.py):

    KITTI_PATH=DIR python -m deepclr_tpu_torch.export_kitti_poses INPUT_PATH

reads the predictions of INPUT_PATH (an inference output directory) through
the port's ``Evaluator``, the calibration of ``DIR/original/sequences/{seq}``,
and writes one 12-column pose file a sequence into ``INPUT_PATH/kitti/``.
"""
import argparse
import os
import os.path as osp
import warnings

import numpy as np

from .data.readers import KittiOdometrySequence, velo2cam
from .evaluation import Evaluator

SEQUENCES = [f"{i:02d}" for i in range(22)]


def mat_to_vec(m: np.ndarray) -> np.ndarray:
    return np.asarray(m)[:3, :].reshape(12)


def convert_poses(evaluator: Evaluator, kitti_base_path: str, sequence_name: str, output_dir: str) -> None:
    calib = KittiOdometrySequence(kitti_base_path, sequence_name).T_cam0_velo
    sequence = evaluator.get_sequence(sequence_name)
    kitti_poses = [mat_to_vec(velo2cam(pose, calib)) for pose in sequence.prediction.poses]
    np.savetxt(osp.join(output_dir, f"{sequence_name}.txt"), np.array(kitti_poses))


def main():
    parser = argparse.ArgumentParser(description="Export predicted transformations as KITTI poses.")
    parser.add_argument("input_path", type=str, help="path with predicted transformations")
    args = parser.parse_args()

    kitti_path = os.getenv("KITTI_PATH")
    if kitti_path is None:
        raise RuntimeError("Environment variable KITTI_PATH not defined.")
    kitti_base_path = osp.join(kitti_path, "original")

    evaluator = Evaluator.read(args.input_path)
    output_dir = osp.join(args.input_path, "kitti")
    os.makedirs(output_dir, exist_ok=True)

    sequence_found = False
    for seq in SEQUENCES:
        if not evaluator.has_sequence(seq):
            continue
        sequence_found = True
        convert_poses(evaluator, kitti_base_path, seq, output_dir)

    if not sequence_found:
        warnings.warn("No sequence found in input directory.")


if __name__ == "__main__":
    main()
