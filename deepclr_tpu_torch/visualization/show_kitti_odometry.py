"""View raw KITTI odometry velodyne data: clouds and the driven path
(scripts/visualization/show_kitti_odometry.py):

    python -m deepclr_tpu_torch.visualization.show_kitti_odometry BASE_PATH SEQUENCE [--save-dir DIR]

iterates a raw (not converted) sequence, shows every 100th cloud in the 3D
viewer, then plots the accumulated path; ``--save-dir`` writes
cloud_{i:06d}.png and path.png instead of showing a window."""
from __future__ import annotations

import argparse
import os.path as osp

import numpy as np

from ..data.readers import KittiOdometryVelodyneData
from ..utils.pcv import PointCloudVisualizer, require_pyplot


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Test KITTI Velodyne Odometry.")
    parser.add_argument("base_path", type=str)
    parser.add_argument("sequence", type=str)
    parser.add_argument("--save-dir", type=str, default=None, help="write renderings to files (headless)")
    args = parser.parse_args(argv)

    plt = require_pyplot()
    df = KittiOdometryVelodyneData(args.base_path, args.sequence)

    visualizer = PointCloudVisualizer()
    visualizer.set_window_size(640, 480)
    visualizer.set_background(0.5, 0.5, 0.5)
    visualizer.set_ground_plane(True)

    path_list = []
    for i, data in enumerate(df):
        path_list.append(data["pose"][:3, 3])
        if i % 100 == 0:
            print(f"Iteration {i + 1}/{len(df)}")
            visualizer.update_point_cloud("cloud", data["cloud"][:, :3], color=[1, 0, 0], size=2)
            if args.save_dir:
                visualizer.save(osp.join(args.save_dir, f"cloud_{i:06d}.png"))
            else:
                visualizer.spin_once(1000)

    path = np.array(path_list)
    plt.figure()
    plt.plot(path[:, 0], path[:, 1], "-")
    plt.xlabel("x [m]")
    plt.ylabel("y [m]")
    plt.axis("equal")
    plt.title(f"Sequence {args.sequence} path")
    if args.save_dir:
        plt.savefig(osp.join(args.save_dir, "path.png"))
    else:
        plt.show()


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        print("Interrupted by user")
