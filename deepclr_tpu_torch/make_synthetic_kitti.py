"""Generate a synthetic KITTI-odometry-layout raw dataset
(scripts/make_synthetic_kitti.py, the same files for the same ``--seed``).

Drives a virtual HDL-64 sensor along a smooth 2-D trajectory through one
persistent procedural scene (``data/synthetic.py::drive``) and writes the
raw layout the KITTI tooling expects:

  OUT/original/sequences/{seq}/velodyne/{i:06d}.bin   float32 x,y,z,refl
  OUT/original/sequences/{seq}/times.txt, calib.txt   (Tr = identity)
  OUT/original/poses/{seq}.txt                        12-col rows

With Tr = identity the cam0 frame equals the velodyne frame.  Then:

  KITTI_PATH=OUT python -m deepclr_tpu_torch.converter.kitti_odometry
  python -m deepclr_tpu_torch.training CONFIG.yaml

Usage: python -m deepclr_tpu_torch.make_synthetic_kitti OUT
       [--sequences 00,01,04] [--frames 160] [--points 32768] [--seed 0] [--speed 1.2]
"""
import argparse
import os
import os.path as osp

import numpy as np

from .data.synthetic import drive


def write_sequence(out, seq, frames, points, seed, speed=1.2):
    rng = np.random.default_rng(seed)
    seq_dir = osp.join(out, "original", "sequences", seq)
    os.makedirs(osp.join(seq_dir, "velodyne"), exist_ok=True)
    os.makedirs(osp.join(out, "original", "poses"), exist_ok=True)

    rows = []
    for i, (pose, cloud) in enumerate(drive(rng, frames, points, speed=speed)):
        cloud.astype(np.float32).tofile(osp.join(seq_dir, "velodyne", f"{i:06d}.bin"))
        rows.append(pose[:3, :].reshape(-1))
        if (i + 1) % 50 == 0:
            print(f"  {seq}: frame {i + 1}/{frames}", flush=True)

    np.savetxt(osp.join(out, "original", "poses", f"{seq}.txt"), np.stack(rows), fmt="%.9f")
    np.savetxt(osp.join(seq_dir, "times.txt"), np.arange(frames) * 0.1, fmt="%.6f")
    with open(osp.join(seq_dir, "calib.txt"), "w") as f:
        f.write("Tr: 1 0 0 0 0 1 0 0 0 0 1 0\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out", type=str)
    ap.add_argument("--sequences", type=str, default="00,01,04")
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--points", type=int, default=32768)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--speed", type=float, default=1.2,
                    help="trajectory speed, m per frame (denser DeepVCP\n                    pairs at lower speeds)")
    args = ap.parse_args()

    for k, seq in enumerate(args.sequences.split(",")):
        print(f"sequence {seq} ({args.frames} frames)")
        write_sequence(args.out, seq, args.frames, args.points, args.seed + 1000 * k, speed=args.speed)
    print("done")


if __name__ == "__main__":
    main()
