"""View the training data loader's batches
(scripts/visualization/view_loader_output.py):

    python -m deepclr_tpu_torch.visualization.view_loader_output CONFIG [--num_batches K] [--save PREFIX]

shows each sample's masked template and source with the deferred
augmentations applied, as ``DeepCLR.encode`` applies them, and prints its
label; ``--save`` writes PREFIX_{batch:02d}_{sample:02d}.png instead."""
from __future__ import annotations

import argparse

import numpy as np

from ..config import Mode, load_config
from ..data import make_data_loader
from ..utils.pcv import PointCloudVisualizer, require_pyplot


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="View data loader batches.")
    parser.add_argument("config", type=str, help="training configuration (*.yaml)")
    parser.add_argument("--num_batches", type=int, default=1)
    parser.add_argument("--save", type=str, default=None)
    args = parser.parse_args(argv)

    require_pyplot()
    cfg = load_config(args.config, Mode.TEST)
    loader = make_data_loader(cfg, is_train=True)

    for bi, batch in enumerate(loader):
        if bi >= args.num_batches:
            break
        for i in range(batch["template"].shape[0]):
            template = batch["template"][i][batch["template_mask"][i]][:, :3]
            source = batch["source"][i][batch["source_mask"][i]][:, :3]
            # bake the deferred augmentations like DeepCLR.encode does
            mt, ms = batch["aug_template"][i], batch["aug_source"][i]
            template = template @ mt[:3, :3].T + mt[:3, 3]
            source = source @ ms[:3, :3].T + ms[:3, 3]

            viz = PointCloudVisualizer()
            viz.add_cloud("template", template, color=(0.2, 0.4, 1.0))
            viz.add_cloud("source", source, color=(1.0, 0.4, 0.2))
            print(f"batch {bi} sample {i}: y={np.round(batch['y'][i], 4)}")
            if args.save:
                viz.save(f"{args.save}_{bi:02d}_{i:02d}.png")
            else:
                viz.spin()
            viz.close()


if __name__ == "__main__":
    main()
