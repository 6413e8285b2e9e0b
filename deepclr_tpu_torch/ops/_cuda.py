"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` file compiles with nvcc into its own shared library with
a plain C interface, loaded through ctypes (no PyTorch headers, so a build
takes seconds, not minutes).  Builds run at first use, one nvcc process per
source, all started together, into ``deepclr_tpu_torch/_build/``.  A
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and a stale library is never loaded.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :class:`CudaKernel` raises when that is not 0 and
counts the launches.  One library may carry several entry points
(``fused_sa.cu``: the forward, its argmax variant and the backward), each a
``CudaKernel`` with its own count.  The sources include no shared header,
so the hash of the one ``.cu`` file covers all the code of its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

__all__ = ["CudaKernel", "build_all", "check_cuda", "launch_counts", "reset_launch_counts"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
SOURCES = ("fps", "min_d2", "fused_sa")
# -fmad=false: the plain versions (and the JAX reference) round every
# product before the add; a contracted FMA would flip FPS picks and radius
# decisions at the boundary.  Kernels that want FMA call __fmaf_rn.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_kernels: Dict[str, "CudaKernel"] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return _BUILD / f"lib{name}_{digest}.so"


def build_all(names=SOURCES) -> Dict[str, Path]:
    """Compile every source not yet built, all in parallel; return the paths.

    The compiler's resource report (-Xptxas -v) goes to ``_build/<name>.log``.
    """
    _BUILD.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        log = open(_BUILD / f"{n}.log", "w")
        procs[n] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{n}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for n, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, paths[n])
        else:
            failed.append(f"{n}.cu (rc={rc}):\n{(_BUILD / f'{n}.log').read_text()[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def _library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build_all((name,))[name]))
    return _libs[name]


class CudaKernel:
    """One C entry point of a csrc/ library, with its launch count.

    ``argtypes`` excludes the trailing stream argument, which is always
    PyTorch's current stream on the given device.
    """

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        _kernels[name] = self

    def _load(self):
        if self._fn is None:
            fn = getattr(_library(self.source), self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        fn = self._load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: kernel launch failed with cudaError {err}")
        self.launches += 1


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last reset."""
    return {name: k.launches for name, k in _kernels.items()}


def reset_launch_counts() -> None:
    for k in _kernels.values():
        k.launches = 0


def check_cuda(name: str, *tensors: torch.Tensor, dtype=torch.float32) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype`` on
    one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
