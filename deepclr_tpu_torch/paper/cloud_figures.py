"""Registration cloud figures (scripts/paper/cloud_figures.py):

    python -m deepclr_tpu_torch.paper.cloud_figures RUN_DIR DATA_FILE SEQUENCE
        [--dataset_type TYPE] [--frame I] [--output PREFIX]

takes the prediction for frame I of SEQUENCE from the inference output
RUN_DIR and sample I of the pack DATA_FILE, and renders the template with
the source before and after the inverse of the predicted transform, as
PREFIX_before.png and PREFIX_after.png (matplotlib)."""
from __future__ import annotations

import argparse

import numpy as np

from ..data import DatasetType, create_input_dataflow
from ..evaluation import Evaluator
from ..utils.pcv import PointCloudVisualizer, require_pyplot


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Render cloud figures.")
    parser.add_argument("run_dir", type=str, help="inference output directory")
    parser.add_argument("data_file", type=str, help="pack data file of the sequence")
    parser.add_argument("sequence", type=str, help="sequence name (e.g. 04)")
    parser.add_argument("--dataset_type", type=str, default="kitti_odometry_velodyne")
    parser.add_argument("--frame", type=int, default=0)
    parser.add_argument("--output", type=str, default="cloud_figure")
    args = parser.parse_args(argv)

    require_pyplot()
    evaluator = Evaluator.read(args.run_dir, [f"{args.sequence}.txt"])
    seq = evaluator.get_sequence(args.sequence)
    pred = seq.prediction.transforms[args.frame]

    df = create_input_dataflow(DatasetType.create(args.dataset_type), args.data_file, shuffle=False)
    for i, sample in enumerate(df):
        if i == args.frame:
            break

    template = sample["clouds"][0][:, :3]
    source = sample["clouds"][1][:, :3]
    aligned = source @ np.linalg.inv(pred)[:3, :3].T + np.linalg.inv(pred)[:3, 3]

    for tag, cloud_b in (("before", source), ("after", aligned)):
        viz = PointCloudVisualizer()
        viz.add_cloud("template", template, color=(0.2, 0.4, 1.0), point_size=0.5)
        viz.add_cloud(f"source_{tag}", cloud_b, color=(1.0, 0.4, 0.2), point_size=0.5)
        out = f"{args.output}_{tag}.png"
        viz.save(out)
        viz.close()
        print(f"saved {out}")


if __name__ == "__main__":
    main()
