"""Data: the `.pack` sample store, the pair-sample dataflows over it, the
host transforms, fixed-shape batching and the data loader."""
from .batching import BatchBuilder, batch_samples, pad_points
from .datasets import build_dataset, create_input_dataflow
from .loader import DataLoader, make_data_loader, make_dataflow
from .pack import PackReader, PackWriter
from .transforms import NoiseType, build_transform, transform_point_cloud
from .types import DatasetType

__all__ = [
    "BatchBuilder",
    "batch_samples",
    "pad_points",
    "build_dataset",
    "create_input_dataflow",
    "DataLoader",
    "make_data_loader",
    "make_dataflow",
    "PackReader",
    "PackWriter",
    "NoiseType",
    "build_transform",
    "transform_point_cloud",
    "DatasetType",
]
