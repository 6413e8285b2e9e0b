"""Fixed-shape batching: pad + mask instead of crop-to-min.

Every cloud is padded (or uniformly subsampled) to a static ``num_points``
with a boolean validity mask; the masked point ops guarantee that padding
never contributes.

Batch dict (numpy, channel-last):
  template/source           (B, num_points, D) float32
  template_mask/source_mask (B, num_points)    bool
  aug_template/aug_source   (B, 4, 4)          float32 (identity if none)
  y                         (B, label_dim)     float32
  d                         list[str]  (host-only: dataset names)
  t                         (B, 2)     float64 (host-only: timestamps)
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from ..geometry import LabelType
from ..geometry.hostmath import label_from_matrix_np
from ..native.morton_sort import morton_sort_rows_native, native_morton_enabled
from ..ops.morton import morton_argsort_np

__all__ = ["pad_points", "BatchBuilder", "batch_samples"]


def _morton_sorted(cloud: np.ndarray) -> np.ndarray:
    """Rows in Morton order: the native radix sort for float32 clouds
    (bit-identical to the numpy argsort; a failed build raises), numpy for
    other dtypes, whose keys would quantise otherwise, and when
    ``DEEPCLR_NATIVE_PAD=0``."""
    if cloud.dtype == np.float32 and native_morton_enabled():
        return morton_sort_rows_native(cloud)
    return cloud[morton_argsort_np(cloud)]


def pad_points(cloud: np.ndarray, num_points: int,
               rng: Optional[np.random.Generator] = None,
               morton: bool = False):
    """Pad with zeros + mask or uniformly subsample to exactly num_points.

    ``morton=True`` also sorts the valid points by their host Morton code
    (``_morton_sorted``; the padding stays at the end), so a
    model built ``presorted`` can skip its first stage's device sort.
    """
    n = cloud.shape[0]
    if n > num_points:
        rng = rng or np.random.default_rng()
        sel = rng.choice(n, size=num_points, replace=False)
        cloud, n = cloud[sel], num_points
    if morton and n > 1:
        cloud = _morton_sorted(cloud)
    if n == num_points:
        return cloud.astype(np.float32, copy=False), np.ones(num_points, bool)
    out = np.zeros((num_points, cloud.shape[1]), np.float32)
    out[:n] = cloud
    mask = np.zeros(num_points, bool)
    mask[:n] = True
    return out, mask


def batch_samples(samples: List[Dict], label_type: LabelType, num_points: int,
                  rng: Optional[np.random.Generator] = None,
                  morton: bool = False) -> Dict:
    """Aggregate unified pair samples into one fixed-shape batch dict; each
    pair pads its template, then its source."""
    rng = rng or np.random.default_rng()
    b = len(samples)
    d_feat = samples[0]["clouds"][0].shape[1]

    template = np.zeros((b, num_points, d_feat), np.float32)
    source = np.zeros((b, num_points, d_feat), np.float32)
    template_mask = np.zeros((b, num_points), bool)
    source_mask = np.zeros((b, num_points), bool)
    aug_template = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    aug_source = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    transforms = np.zeros((b, 4, 4), np.float64)
    names: List[str] = []
    stamps = np.zeros((b, 2), np.float64)

    for i, s in enumerate(samples):
        template[i], template_mask[i] = pad_points(s["clouds"][0], num_points, rng, morton=morton)
        source[i], source_mask[i] = pad_points(s["clouds"][1], num_points, rng, morton=morton)
        if s["augmentations"][0] is not None:
            aug_template[i] = s["augmentations"][0]
        if s["augmentations"][1] is not None:
            aug_source[i] = s["augmentations"][1]
        transforms[i] = s["transform"]
        names.append(str(s.get("dataset", "data")))
        stamps[i] = np.asarray(s["timestamps"], np.float64)

    y = label_from_matrix_np(label_type, transforms).astype(np.float32)
    return {
        "template": template,
        "source": source,
        "template_mask": template_mask,
        "source_mask": source_mask,
        "aug_template": aug_template,
        "aug_source": aug_source,
        "y": y,
        "d": names,
        "t": stamps,
    }


class BatchBuilder:
    """Stream samples into fixed-size batches; the last, smaller batch is
    dropped when ``remainder=False``."""

    def __init__(self, batch_size: int, label_type: LabelType, num_points: int,
                 remainder: bool = True, seed: int = 0, morton: bool = False):
        self.batch_size = int(batch_size)
        self.label_type = label_type
        self.num_points = int(num_points)
        self.remainder = remainder
        self.morton = morton
        self._rng = np.random.default_rng(seed)

    def __call__(self, samples: Iterator[Dict]) -> Iterator[Dict]:
        holder: List[Dict] = []
        for s in samples:
            holder.append(s)
            if len(holder) == self.batch_size:
                yield batch_samples(holder, self.label_type, self.num_points, self._rng, morton=self.morton)
                holder = []
        if self.remainder and holder:
            yield batch_samples(holder, self.label_type, self.num_points, self._rng, morton=self.morton)
