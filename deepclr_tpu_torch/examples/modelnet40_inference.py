"""Minimal pairwise-inference demo on raw ModelNet40 data
(scripts/examples/modelnet40_inference.py):

    MODELNET40_PATH=DIR MODEL_PATH=MODELS python -m deepclr_tpu_torch.examples.modelnet40_inference \
        MODEL_NAME [--num_samples 5] [--device cuda]

reduces each test model of DIR/original to 2048 points (host FPS), registers
it against a copy under a random transform (+-0.1 m, +-5 deg, drawn unseeded
as in the JAX demo) and prints the translation error and the predicted
transform.
"""
import argparse
import os
import os.path as osp

import numpy as np

from ..data.transforms import ApplyAugmentations, Compose, FarthestPointSampling, NoiseType, RandomTransform
from ..geometry.hostmath import label_to_matrix_np
from ..models import ModelInferenceHelper
from ._model import load_demo_model


def main():
    parser = argparse.ArgumentParser(description="Model inference for ModelNet40 data.")
    parser.add_argument("model_name", type=str, help="Model name (directory in MODEL_PATH)")
    parser.add_argument("--num_samples", type=int, default=5)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()

    modelnet40_path = os.getenv("MODELNET40_PATH")
    if modelnet40_path is None:
        raise RuntimeError("Could not get ModelNet40 path from environment variable MODELNET40_PATH.")
    directory = osp.join(modelnet40_path, "original")
    listfile = osp.join(directory, "modelnet40_test.txt")

    model_path = os.getenv("MODEL_PATH")
    if model_path is None:
        raise RuntimeError("Could not get model path from environment variable MODEL_PATH.")
    model_cfg, model = load_demo_model(osp.join(model_path, args.model_name), args.device)
    helper = ModelInferenceHelper(model, is_sequential=False, num_points=2048)

    names = [line.rstrip("\n") for line in open(listfile)]
    files = [osp.join(directory, n.rpartition("_")[0], f"{n}.txt") for n in names]

    transform = Compose([
        FarthestPointSampling(2048),
        RandomTransform(0.1, 5.0, translation_noise_type=NoiseType.UNIFORM,
                        rotation_noise_deg_type=NoiseType.UNIFORM),
        ApplyAugmentations(),
    ])

    for f in files[: args.num_samples]:
        cloud = np.loadtxt(f, delimiter=",")[:, :3].astype(np.float32)
        sample = {
            "dataset": "demo",
            "idx": [0, 0],
            "timestamps": [0.0, 0.0],
            "clouds": [cloud, cloud.copy()],
            "transform": np.eye(4),
            "augmentations": [None, None],
        }
        sample = transform(sample)

        y_pred = helper.predict(sample["clouds"][1], sample["clouds"][0])
        m_pred = label_to_matrix_np(model_cfg.label_type, y_pred)
        m_gt = sample["transform"]
        t_err = np.linalg.norm(m_pred[:3, 3] - m_gt[:3, 3])
        print(f"{osp.basename(f)}: translation error {t_err:.4f} m")
        print(m_pred)


if __name__ == "__main__":
    main()
