"""Data: the `.pack` sample store and the pair-sample dataflows over it."""
from .datasets import build_dataset, create_input_dataflow
from .pack import PackReader, PackWriter
from .types import DatasetType

__all__ = [
    "DatasetType",
    "PackReader",
    "PackWriter",
    "build_dataset",
    "create_input_dataflow",
]
