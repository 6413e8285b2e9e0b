"""View raw ModelNet40 point clouds (scripts/visualization/show_modelnet40.py):

    python -m deepclr_tpu_torch.visualization.show_modelnet40 LIST_FILE [--shapes S ...] [--save-dir DIR]

iterates the models of a split list, shows every 10th cloud in the 3D
viewer; ``--save-dir`` writes model_{i:06d}.png instead."""
from __future__ import annotations

import argparse
import os.path as osp

from ..data.readers import ModelNet40PointClouds
from ..utils.pcv import PointCloudVisualizer, require_pyplot


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Test ModelNet40.")
    parser.add_argument("filename", type=str, help="TXT file with list of all model files.")
    parser.add_argument("--shapes", default=None, type=str, nargs="*")
    parser.add_argument("--save-dir", type=str, default=None, help="write renderings to files (headless)")
    args = parser.parse_args(argv)

    require_pyplot()
    df = ModelNet40PointClouds(args.filename, args.shapes)

    visualizer = PointCloudVisualizer()
    visualizer.set_window_size(640, 480)
    visualizer.set_background(0.5, 0.5, 0.5)
    visualizer.set_ground_plane(True)

    for i, data in enumerate(df):
        if i % 10 == 0:
            print(f"Iteration {i + 1}/{len(df)}")
            visualizer.update_point_cloud("cloud", data["cloud"][:, :3], color=[1, 0, 0], size=2)
            if args.save_dir:
                visualizer.save(osp.join(args.save_dir, f"model_{i:06d}.png"))
            else:
                visualizer.spin_once(1000)


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        print("Interrupted by user")
