"""Dataset assembly: pack-file iterators -> unified pair samples.

Unified sample schema:
  {dataset: str, idx: [i, j], timestamps: [t0, t1],
   clouds: [np(n0,D), np(n1,D)], transform: np(4,4),
   augmentations: [None|np(4,4), None|np(4,4)]}

Storage layouts:
  * sequence packs (KITTI odometry): one record per frame
    {idx, timestamp, pose(4,4), cloud}; pairs are formed by a sliding
    window and the motion label is inv(p0) @ p1,
  * pair packs (kitti_pairs, ModelNet40 test sets): one record per
    prebuilt pair sample,
  * model packs (ModelNet40 train): one record per single cloud
    {idx, cloud}; pairs are self-duplicates with identity transform.

Shuffling draws from ``numpy.random.default_rng(seed)`` in the JAX
package's order, so a seed gives the same sample order in both packages.
"""
from __future__ import annotations

import os.path as osp
from typing import Iterator, List, Union

import numpy as np

from .pack import PackReader
from .types import DatasetType

__all__ = [
    "ConcatData",
    "DatasetType",
    "PackPairData",
    "PackSelfPairs",
    "PackSequencePairs",
    "RandomMixData",
    "build_dataset",
    "create_input_dataflow",
]


def _get_motion(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    return np.linalg.inv(p0) @ p1


def _to_float32(x):
    if isinstance(x, np.ndarray):
        return x.astype(np.float32)
    if isinstance(x, list):
        return [_to_float32(v) for v in x]
    if isinstance(x, dict):
        return {k: _to_float32(v) for k, v in x.items()}
    return x


class _PackData:
    """A re-iterable dataflow over one pack file, with a length."""

    def __init__(self, path: str, shuffle: bool = False, seed: int = 0):
        self._reader = PackReader(path)
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._name = osp.splitext(osp.basename(path))[0]

    def __len__(self) -> int:
        return len(self._reader)

    def _keys(self) -> List[str]:
        keys = list(self._reader.keys)
        if self._shuffle:
            self._rng.shuffle(keys)
        return keys


class PackPairData(_PackData):
    """Iterate prebuilt pair samples from a pack (GENERIC datasets)."""

    def __iter__(self) -> Iterator[dict]:
        for k in self._keys():
            sample = self._reader[k]
            sample.setdefault("dataset", self._name)
            sample.setdefault("augmentations", [None, None])
            yield _to_float32(sample)


class PackSequencePairs(_PackData):
    """Sliding window of 2 over per-frame records (KITTI odometry)."""

    def __len__(self) -> int:
        return max(len(self._reader) - 1, 0)

    def __iter__(self) -> Iterator[dict]:
        keys = self._reader.keys  # sorted
        starts = list(range(len(keys) - 1))
        if self._shuffle:
            self._rng.shuffle(starts)
        for s in starts:
            f0 = self._reader[keys[s]]
            f1 = self._reader[keys[s + 1]]
            sample = {
                "dataset": self._name,
                "idx": [f0["idx"], f1["idx"]],
                "timestamps": [f0["timestamp"], f1["timestamp"]],
                "clouds": [f0["cloud"], f1["cloud"]],
                "transform": _get_motion(
                    np.asarray(f0["pose"], float), np.asarray(f1["pose"], float)
                ),
                "augmentations": [None, None],
            }
            yield _to_float32(sample)


class PackSelfPairs(_PackData):
    """Duplicate single clouds into self-pairs (ModelNet40 training)."""

    def __iter__(self) -> Iterator[dict]:
        for k in self._keys():
            rec = self._reader[k]
            cloud = rec["cloud"]
            idx = rec.get("idx", 0)
            sample = {
                "dataset": self._name,
                "idx": [idx, idx],
                "timestamps": [idx, idx],
                "clouds": [cloud, np.array(cloud, copy=True)],
                "transform": np.eye(4),
                "augmentations": [None, None],
            }
            yield _to_float32(sample)


class ConcatData:
    """Sequential concatenation of dataflows."""

    def __init__(self, dfs: List):
        self._dfs = dfs

    def __len__(self) -> int:
        return sum(len(d) for d in self._dfs)

    def __iter__(self):
        for d in self._dfs:
            yield from d


class RandomMixData:
    """Randomly interleave multiple dataflows."""

    def __init__(self, dfs: List, seed: int = 0):
        self._dfs = dfs
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return sum(len(d) for d in self._dfs)

    def __iter__(self):
        iters = [iter(d) for d in self._dfs]
        # one entry per remaining sample, identifying its source flow
        source = np.concatenate([
            np.full(len(d), i, np.int32) for i, d in enumerate(self._dfs)
        ])
        self._rng.shuffle(source)
        for i in source:
            yield next(iters[i])


_FLOWS = {
    DatasetType.GENERIC: PackPairData,
    DatasetType.KITTI_ODOMETRY_VELODYNE: PackSequencePairs,
    DatasetType.MODELNET40: PackSelfPairs,
}


def create_input_dataflow(dataset_type: DatasetType, filename: str,
                          shuffle: bool = False, seed: int = 0) -> _PackData:
    """One pack file -> unified pair-sample dataflow."""
    if dataset_type not in _FLOWS:
        raise NotImplementedError(f"DatasetType '{dataset_type}' not implemented")
    return _FLOWS[dataset_type](filename, shuffle=shuffle, seed=seed)


def build_dataset(dataset_type: DatasetType, source: Union[str, List],
                  shuffle: bool = False, seed: int = 0):
    """One or many pack files -> mixed/concatenated dataflow."""
    if isinstance(source, (list, tuple)):
        dfs = [
            create_input_dataflow(dataset_type, f, shuffle=shuffle, seed=seed + i)
            for i, f in enumerate(source)
        ]
        return RandomMixData(dfs, seed=seed) if shuffle else ConcatData(dfs)
    return create_input_dataflow(dataset_type, source, shuffle=shuffle, seed=seed)
