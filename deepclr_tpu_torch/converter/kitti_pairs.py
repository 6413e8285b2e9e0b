"""Convert KITTI sequences into DeepVCP-style training pairs: an anchor every
30 frames, pairs within 5 m, the ground-truth motion baked into the source
cloud (scripts/converter/kitti_pairs.py).

    KITTI_PATH=DIR python -m deepclr_tpu_torch.converter.kitti_pairs

reads ``DIR/original`` and writes ``DIR/pairs/{seq}.pack``.
"""
import os
import os.path as osp

import numpy as np

from ..data.pack import PackWriter
from ..data.readers import KittiSamplePairData
from ..data.transforms import ApplyAugmentations, Compose, RemoveTransform, SystematicErasing

SEQUENCES = [f"{i:02d}" for i in range(11)]
NTH = 2
FRAME_INTERVAL = 30
MAX_DISTANCE = 5.0


def merge_pair(frames, dataset: str) -> dict:
    f0, f1 = frames
    return {
        "dataset": dataset,
        "idx": [f0["idx"], f1["idx"]],
        "timestamps": [f0["timestamp"], f1["timestamp"]],
        "clouds": [f0["cloud"], f1["cloud"]],
        "transform": np.linalg.inv(f0["pose"]) @ f1["pose"],
        "augmentations": [None, None],
    }


def convert_sequence(base_path: str, sequence: str, output_file: str) -> None:
    df = KittiSamplePairData(base_path, sequence, frame_interval=FRAME_INTERVAL, max_distance=MAX_DISTANCE,
                             shuffle=False)
    transform = Compose([RemoveTransform(), SystematicErasing(NTH), ApplyAugmentations()])
    with PackWriter(output_file) as w:
        for i, frames in enumerate(df):
            w.put(f"{i:08d}", transform(merge_pair(frames, sequence)))


def main():
    kitti_path = os.getenv("KITTI_PATH")
    if kitti_path is None:
        raise RuntimeError("Environment variable KITTI_PATH not defined.")
    kitti_base_path = osp.join(kitti_path, "original")
    kitti_pairs_path = osp.join(kitti_path, "pairs")
    os.makedirs(kitti_pairs_path, exist_ok=True)

    for seq in SEQUENCES:
        if not osp.isdir(osp.join(kitti_base_path, "sequences", seq, "velodyne")):
            print(f"Skip sequence {seq} (no velodyne data)")
            continue
        print(f"Convert sequence {seq}")
        convert_sequence(kitti_base_path, seq, osp.join(kitti_pairs_path, f"{seq}.pack"))


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        print("Interrupted by user")
