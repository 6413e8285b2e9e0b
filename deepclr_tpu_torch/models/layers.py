"""Shared MLP building blocks (channel-last, per-point Dense + ReLU).

Parameters are float32; products run in the module's compute dtype.  A
Dense layer rounds where a Flax ``Dense(dtype=compute_dtype)`` rounds: the
inputs and the kernel are cast to the compute dtype, the product comes out
in it (float32 accumulation inside the matmul), and the bias add rounds
again.  ReLU follows every layer, the last one included.

Module names follow the reference PyTorch DeepCLR state dict
(``deepclr_tpu/models/torch_convert.py``): an MLP's layer ``i`` holds its
Dense at ``_sequential.{i}._sequential.0``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

__all__ = ["Dense", "MLP"]


class Dense(nn.Module):
    """y = x Wᵀ + b, weight (out, in) and bias (out,) in float32.

    ``init`` names the weight initializer ``reset_parameters`` draws from:
    "xavier_uniform" or "kaiming_normal" (He, truncated at 2 std).
    ``bias_value`` seeds the bias (zeros when None).
    """

    def __init__(self, in_features: int, out_features: int, init: str = "xavier_uniform",
                 bias_value: Optional[Sequence[float]] = None):
        super().__init__()
        if init not in ("xavier_uniform", "kaiming_normal"):
            raise ValueError(f"unknown initializer {init!r}")
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.init = init
        self.bias_value = None if bias_value is None else list(bias_value)

    def reset_parameters(self, generator: torch.Generator) -> None:
        w = torch.empty(self.weight.shape)
        if self.init == "xavier_uniform":
            nn.init.xavier_uniform_(w, generator=generator)
        else:
            # variance 2/fan_in after truncation at +-2 std
            std = math.sqrt(2.0 / w.shape[1]) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        b = torch.zeros(self.bias.shape) if self.bias_value is None else torch.tensor(self.bias_value)
        with torch.no_grad():
            self.weight.copy_(w)
            self.bias.copy_(b)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        y = torch.matmul(x.to(compute_dtype), self.weight.to(compute_dtype).t())
        return y + self.bias.to(compute_dtype)


class _Layer(nn.Module):
    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self._sequential = nn.ModuleList([Dense(in_features, out_features)])


class MLP(nn.Module):
    """Stack of Dense + ReLU layers: (..., in_dim) -> (..., widths[-1]) in
    ``compute_dtype``.  ``forward``'s ``post``, when given, follows every
    layer's ReLU: the pose head's dropout (``OutputSimple``)."""

    def __init__(self, in_dim: int, widths: Sequence[int], compute_dtype=torch.float32):
        super().__init__()
        dims = [in_dim, *widths]
        self._sequential = nn.ModuleList([_Layer(dims[i], dims[i + 1]) for i in range(len(widths))])
        self.compute_dtype = compute_dtype

    def dense(self, i: int) -> Dense:
        return self._sequential[i]._sequential[0]

    def __len__(self) -> int:
        return len(self._sequential)

    def forward(self, x: torch.Tensor,
                post: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        for i in range(len(self)):
            x = torch.relu(self.dense(i)(x, self.compute_dtype))
            if post is not None:
                x = post(x)
        return x
