"""ModelNet40 noisy test sets: self-pairs perturbed by a uniform random
transform (+-0.1 m, +-5 deg) and Gaussian point noise of sigma 0.00 ... 0.10
(scripts/converter/modelnet40_test.py).

    MODELNET40_PATH=DIR python -m deepclr_tpu_torch.converter.modelnet40_test

reads ``DIR/models/test_{seen,unseen}.pack`` and writes
``DIR/test/test_{split}_{sigma:.2f}.pack``.  The perturbations are drawn
unseeded, as in the JAX script.
"""
import os
import os.path as osp

from ..data import DatasetType, create_input_dataflow
from ..data.pack import PackWriter
from ..data.transforms import ApplyAugmentations, Compose, NoiseType, PointNoise, RandomTransform

NOISE_LEVELS = [0.00, 0.01, 0.02, 0.03, 0.04, 0.05, 0.06, 0.07, 0.08, 0.09, 0.10]
TRANSLATION = 0.1
ROTATION = 5.0


def process_file(input_file: str, noise: float, output_file: str) -> None:
    df = create_input_dataflow(DatasetType.MODELNET40, input_file, shuffle=False)
    transform = Compose([
        RandomTransform(TRANSLATION, ROTATION, translation_noise_type=NoiseType.UNIFORM,
                        rotation_noise_deg_type=NoiseType.UNIFORM),
        PointNoise(noise, noise_type=NoiseType.NORMAL, target_only=False),
        ApplyAugmentations(),
    ])
    with PackWriter(output_file) as w:
        for i, sample in enumerate(df):
            w.put(f"{i:08d}", transform(sample))


def main():
    modelnet40_path = os.getenv("MODELNET40_PATH")
    if modelnet40_path is None:
        raise RuntimeError("Environment variable MODELNET40_PATH not defined.")
    models = osp.join(modelnet40_path, "models")
    test = osp.join(modelnet40_path, "test")
    os.makedirs(test, exist_ok=True)

    for noise in NOISE_LEVELS:
        for split in ("seen", "unseen"):
            print(f"Process {split} shapes with noise level '{noise:.2f}'")
            process_file(osp.join(models, f"test_{split}.pack"), noise,
                         osp.join(test, f"test_{split}_{noise:.2f}.pack"))


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        print("Interrupted by user")
