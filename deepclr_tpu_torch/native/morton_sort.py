"""ctypes binding of the native Morton row sort (csrc/host/morton_sort.cpp).

The pad-time presort of ``data.batching.pad_points(morton=True)``: the same
double-precision quantisation and a stable radix sort, so its permutation
is bit-identical to ``ops.morton_argsort_np``'s stable argsort, with the
key build, sort and row gather in one call.  ``DEEPCLR_NATIVE_PAD=0``
selects the numpy path instead.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from . import load_library

__all__ = ["morton_sort_rows_native", "native_morton_enabled"]

_fn = None


def native_morton_enabled() -> bool:
    """False when ``DEEPCLR_NATIVE_PAD=0`` asks for the numpy path."""
    return os.environ.get("DEEPCLR_NATIVE_PAD", "1") != "0"


def _load():
    global _fn
    if _fn is None:
        fn = load_library("morton_sort").morton_sort_rows
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long, ctypes.POINTER(ctypes.c_float)]
        _fn = fn
    return _fn


def morton_sort_rows_native(cloud: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Morton-sort the rows of an (N, D>=3) float32 cloud; equal to
    ``cloud[morton_argsort_np(cloud)]`` bit for bit.  Writes into ``out``
    ((N, D) float32, C-contiguous, not aliasing ``cloud``) when given."""
    fn = _load()
    cloud = np.ascontiguousarray(cloud, np.float32)
    n, d = cloud.shape
    if out is None:
        out = np.empty((n, d), np.float32)
    rc = fn(cloud.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, d,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f"morton_sort_rows failed (rc={rc})")
    return out
