"""ModelNet40 -> .pack model stores: 2048-point clouds by host farthest-point
sampling, seen / unseen shape splits (scripts/converter/modelnet40.py).

    MODELNET40_PATH=DIR python -m deepclr_tpu_torch.converter.modelnet40

reads ``DIR/original`` and writes ``DIR/models/{train,test_seen,test_unseen}.pack``.
"""
import os
import os.path as osp
from typing import List

from ..data.pack import PackWriter
from ..data.readers import ModelNet40PointClouds
from ..data.transforms import FarthestPointSampling

SHAPES_SEEN = ['airplane', 'bathtub', 'bed', 'bench', 'bookshelf', 'bottle', 'bowl', 'car', 'chair', 'cone', 'cup',
               'curtain', 'desk', 'door', 'dresser', 'flower_pot', 'glass_box', 'guitar', 'keyboard', 'lamp']
SHAPES_UNSEEN = ['laptop', 'mantel', 'monitor', 'night_stand', 'person', 'piano', 'plant', 'radio', 'range_hood',
                 'sink', 'sofa', 'stairs', 'stool', 'table', 'tent', 'toilet', 'tv_stand', 'vase', 'wardrobe', 'xbox']
FPS = 2048


def process_file(input_file: str, shapes: List[str], output_file: str) -> None:
    df = ModelNet40PointClouds(input_file, shapes, shuffle=False)
    fps = FarthestPointSampling(FPS)
    with PackWriter(output_file) as w:
        for i, sample in enumerate(df):
            w.put(f"{i:08d}", fps(sample))


def main():
    modelnet40_path = os.getenv("MODELNET40_PATH")
    if modelnet40_path is None:
        raise RuntimeError("Environment variable MODELNET40_PATH not defined.")
    original = osp.join(modelnet40_path, "original")
    models = osp.join(modelnet40_path, "models")
    os.makedirs(models, exist_ok=True)

    processing = [
        ("modelnet40_train.txt", SHAPES_SEEN, "train.pack"),
        ("modelnet40_test.txt", SHAPES_SEEN, "test_seen.pack"),
        ("modelnet40_test.txt", SHAPES_UNSEEN, "test_unseen.pack"),
    ]
    for input_filename, shapes, output_filename in processing:
        print(f"Create '{output_filename}'")
        process_file(osp.join(original, input_filename), shapes, osp.join(models, output_filename))


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        print("Interrupted by user")
