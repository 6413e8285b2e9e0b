"""Device selection and float32 policy shared by the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "strict_float32"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU.  Raises when CUDA is asked for and no GPU is present, so a missing
    card never turns silently into a CPU run."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepclr_tpu_torch: CUDA device requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return device


def strict_float32() -> None:
    """Turn TF32 off for matmuls and cuDNN.  Distances, the layer-1 splits
    and the pose head are meant as float32; TF32 keeps ~3 decimal digits and
    flips neighbour selections at the radius boundaries."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
