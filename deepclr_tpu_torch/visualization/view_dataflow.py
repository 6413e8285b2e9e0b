"""View samples of a converted ``.pack`` dataset
(scripts/visualization/view_dataflow.py):

    python -m deepclr_tpu_torch.visualization.view_dataflow DATA_FILE
        [--dataset_type TYPE] [--num_samples K] [--save PREFIX]

shows the template and source clouds of the first K samples and prints
each sample's transform; ``--save`` writes PREFIX_{i:03d}.png instead."""
from __future__ import annotations

import argparse

from ..data import DatasetType, create_input_dataflow
from ..utils.pcv import PointCloudVisualizer, require_pyplot


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="View dataflow samples.")
    parser.add_argument("data_file", type=str, help="pack data file")
    parser.add_argument("--dataset_type", type=str, default="generic", choices=[t.value for t in DatasetType])
    parser.add_argument("--num_samples", type=int, default=3)
    parser.add_argument("--save", type=str, default=None, help="save images to this prefix instead of showing")
    args = parser.parse_args(argv)

    require_pyplot()
    df = create_input_dataflow(DatasetType.create(args.dataset_type), args.data_file, shuffle=False)
    for i, sample in enumerate(df):
        if i >= args.num_samples:
            break
        viz = PointCloudVisualizer()
        viz.add_cloud("template", sample["clouds"][0], color=(0.2, 0.4, 1.0))
        viz.add_cloud("source", sample["clouds"][1], color=(1.0, 0.4, 0.2))
        print(f"sample {i}: transform=\n{sample['transform']}")
        if args.save:
            viz.save(f"{args.save}_{i:03d}.png")
        else:
            viz.spin()
        viz.close()


if __name__ == "__main__":
    main()
