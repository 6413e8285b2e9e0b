"""KITTI artificial test pairs: a uniform random perturbation (+-1 m, +-1 deg)
baked into the source cloud (scripts/converter/kitti_pairs_test.py).

    KITTI_PATH=DIR python -m deepclr_tpu_torch.converter.kitti_pairs_test

reads ``DIR/pairs/{seq}.pack`` and writes ``DIR/pairs_test/{seq}.pack``.  The
perturbations are drawn unseeded, as in the JAX script.
"""
import os
import os.path as osp

from ..data import DatasetType, create_input_dataflow
from ..data.pack import PackWriter
from ..data.transforms import ApplyAugmentations, Compose, NoiseType, RandomTransform

SEQUENCES = [f"{i:02d}" for i in range(11)]
TRANSLATION = 1.0
ROTATION = 1.0


def convert_sequence(input_file: str, output_file: str) -> None:
    df = create_input_dataflow(DatasetType.GENERIC, input_file, shuffle=False)
    transform = Compose([
        RandomTransform(TRANSLATION, ROTATION, translation_noise_type=NoiseType.UNIFORM,
                        rotation_noise_deg_type=NoiseType.UNIFORM),
        ApplyAugmentations(),
    ])
    with PackWriter(output_file) as w:
        for i, sample in enumerate(df):
            w.put(f"{i:08d}", transform(sample))


def main():
    kitti_path = os.getenv("KITTI_PATH")
    if kitti_path is None:
        raise RuntimeError("Environment variable KITTI_PATH not defined.")
    kitti_pairs_path = osp.join(kitti_path, "pairs")
    kitti_pairs_test_path = osp.join(kitti_path, "pairs_test")
    os.makedirs(kitti_pairs_test_path, exist_ok=True)

    for seq in SEQUENCES:
        if not osp.isfile(osp.join(kitti_pairs_path, f"{seq}.pack")):
            print(f"Skip sequence {seq} (no pairs pack)")
            continue
        print(f"Process sequence {seq}")
        convert_sequence(osp.join(kitti_pairs_path, f"{seq}.pack"), osp.join(kitti_pairs_test_path, f"{seq}.pack"))


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        print("Interrupted by user")
