"""Model weights from the seed, made on the device in two calls (one
normal, one uniform draw over every parameter at once) by a
``torch.Generator`` there, then cut into leaves: He-normal ball MLPs,
Xavier-uniform other weights, biases uniform in +-0.02, and the pose layer's
bias at the identity label [1, 0, ..., 0] plus that noise.  The same seed on
the same device gives the same weights, to the program and to the
reference alike."""
from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.deepclr import param_spec

BIAS_SCALE = 0.02


def make_weights(model_cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    spec = param_spec(model_cfg)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, init in spec:
        n = math.prod(shape)
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if init == "he":
            w = z * math.sqrt(2.0 / shape[1])
        elif init == "xavier":
            w = u * math.sqrt(6.0 / (shape[0] + shape[1]))
        elif init == "bias":
            w = u * BIAS_SCALE
        elif init == "label_bias":  # the pose layer's: the identity dual quaternion
            w = u * BIAS_SCALE
            w[0] += 1.0
        else:
            raise ValueError(f"weights: unknown init {init!r} of {name}")
        out[name] = w.contiguous()
    return out
