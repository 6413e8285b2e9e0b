"""Generate a synthetic ModelNet40-layout dataset tree
(scripts/make_synthetic_modelnet.py, the same files for the same ``--seed``):
CAD-like surface clouds (``data/synthetic.py::cad_cloud``: unions of box,
cylinder, sphere and torus primitives with exact normals, normalised to the
unit sphere) in the raw layout the converters expect:

  OUT/original/{shape}/{shape}_{i:04d}.txt   csv, 6 cols xyz+normals
  OUT/original/modelnet40_train.txt / modelnet40_test.txt

Then:

  MODELNET40_PATH=OUT python -m deepclr_tpu_torch.converter.modelnet40
  MODELNET40_PATH=OUT python -m deepclr_tpu_torch.converter.modelnet40_test

Usage: python -m deepclr_tpu_torch.make_synthetic_modelnet OUT
       [--train-per-shape 8] [--test-per-shape 2] [--points 8192] [--seed 0]
"""
import argparse
import os
import os.path as osp

import numpy as np

from .converter.modelnet40 import SHAPES_SEEN, SHAPES_UNSEEN
from .data.synthetic import cad_cloud


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out", type=str)
    ap.add_argument("--train-per-shape", type=int, default=8)
    ap.add_argument("--test-per-shape", type=int, default=2)
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    original = osp.join(args.out, "original")
    rng = np.random.default_rng(args.seed)
    train_names, test_names = [], []
    for shape in [*SHAPES_SEEN, *SHAPES_UNSEEN]:
        os.makedirs(osp.join(original, shape), exist_ok=True)
        total = args.train_per_shape + args.test_per_shape
        for i in range(total):
            name = f"{shape}_{i + 1:04d}"
            cloud = cad_cloud(rng, args.points)
            np.savetxt(osp.join(original, shape, f"{name}.txt"), cloud, delimiter=",", fmt="%.6f")
            (train_names if i < args.train_per_shape else test_names).append(name)
        print(f"{shape}: {total} models")

    for listing, names in (("modelnet40_train.txt", train_names), ("modelnet40_test.txt", test_names)):
        with open(osp.join(original, listing), "w") as f:
            f.write("\n".join(names) + "\n")
    print(f"wrote {len(train_names)} train / {len(test_names)} test models")


if __name__ == "__main__":
    main()
