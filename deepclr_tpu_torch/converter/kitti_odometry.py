"""Convert raw KITTI odometry sequences into per-frame .pack stores: every
2nd velodyne point (scripts/converter/kitti_odometry.py).

    KITTI_PATH=DIR python -m deepclr_tpu_torch.converter.kitti_odometry

reads ``DIR/original/sequences/{seq}`` and writes ``DIR/odometry/{seq}.pack``.
"""
import os
import os.path as osp

from ..data.pack import PackWriter
from ..data.readers import KittiOdometryVelodyneData
from ..data.transforms import SystematicErasing

SEQUENCES = [f"{i:02d}" for i in range(22)]
NTH = 2


def convert_sequence(base_path: str, sequence: str, output_file: str) -> None:
    df = KittiOdometryVelodyneData(base_path, sequence, shuffle=False)
    erase = SystematicErasing(NTH)
    with PackWriter(output_file) as w:
        for i, sample in enumerate(df):
            w.put(f"{i:08d}", erase(sample))


def main():
    kitti_path = os.getenv("KITTI_PATH")
    if kitti_path is None:
        raise RuntimeError("Environment variable KITTI_PATH not defined.")
    kitti_base_path = osp.join(kitti_path, "original")
    kitti_odometry_path = osp.join(kitti_path, "odometry")
    os.makedirs(kitti_odometry_path, exist_ok=True)

    for seq in SEQUENCES:
        if not osp.isdir(osp.join(kitti_base_path, "sequences", seq, "velodyne")):
            print(f"Skip sequence {seq} (no velodyne data)")
            continue
        print(f"Convert sequence {seq}")
        convert_sequence(kitti_base_path, seq, osp.join(kitti_odometry_path, f"{seq}.pack"))


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        print("Interrupted by user")
