"""Host-side native (C++) libraries of the port and their ctypes bindings.

The sources are the port's own copies in ``deepclr_tpu_torch/csrc/host/``:

  * kitti_devkit.cpp — the KITTI odometry benchmark evaluator,
  * pack_reader.cpp  — an mmap ``.pack`` store reader (zero-copy records),
  * morton_sort.cpp  — the pad-time Morton presort (a stable radix sort,
    bit-identical to ``ops.morton_argsort_np``).

Each builds at first use with ``g++ -O3 -std=c++17 -shared -fPIC`` into
``deepclr_tpu_torch/_build/``; the library's file name carries a hash of its
source and flags, so an edited source is rebuilt and a stale library is never
loaded.  A build writes a temporary file and renames it, so processes that
build at once do not see each other's half-written files.  A failed build
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import subprocess
from pathlib import Path
from typing import Dict, Optional

__all__ = ["build_library", "kitti_devkit_eval", "load_library"]

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "host"
_BUILD = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def build_library(name: str) -> str:
    """Compile ``csrc/host/{name}.cpp`` unless its library exists; returns the path."""
    src = _SRC / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    out = _BUILD / f"lib{name}_{digest}.so"
    if out.exists():
        return str(out)
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src.name} (rc={proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return str(out)


def load_library(name: str) -> ctypes.CDLL:
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build_library(name))
    return _loaded[name]


def kitti_devkit_eval(gt_dir: str, pred_dir: str, result_dir: Optional[str] = None) -> int:
    """Run the KITTI odometry evaluator on every sequence present in both
    directories; writes the error tables and stats into ``result_dir``
    (default: pred_dir/result).  Returns the number of sequences evaluated."""
    lib = load_library("kitti_devkit")
    lib.kitti_eval.restype = ctypes.c_int
    lib.kitti_eval.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
    result_dir = result_dir or osp.join(pred_dir, "result")
    n = lib.kitti_eval(gt_dir.encode(), pred_dir.encode(), result_dir.encode())
    if n < 0:
        raise RuntimeError("kitti_devkit evaluation failed")
    return n
