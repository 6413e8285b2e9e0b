"""Shared MLP building blocks (channel-last, per-point Dense + ReLU).

Parameters are float32; products run in the module's compute dtype.  A
Dense layer rounds where a Flax ``Dense(dtype=compute_dtype)`` rounds: the
inputs and the kernel are cast to the compute dtype, the product comes out
in it (float32 accumulation inside the matmul), and the bias add rounds
again.  ReLU follows every layer, the last one included; with batch norm
a layer is Dense -> BatchNorm -> ReLU.

Module names follow the reference PyTorch DeepCLR state dict
(``deepclr_tpu/models/torch_convert.py``): an MLP's layer ``i`` holds its
Dense at ``_sequential.{i}._sequential.0`` and its batch norm at
``_sequential.{i}._sequential.1``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

__all__ = ["BatchNorm", "Dense", "MLP"]


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


class BatchNorm(nn.Module):
    """Batch norm over every axis but the last, as ``flax.linen.BatchNorm``
    computes it (not ``torch.nn.BatchNorm1d``): in training mode the batch's
    mean and *biased* variance, E[x²] − E[x]² clipped at 0, in float32, and
    the running statistics updated as ra = 0.99·ra + 0.01·batch (Flax's
    ``momentum`` is the kept share); in evaluation mode the running
    statistics.  y = (x − mean)·rsqrt(var + 1e-5)·weight + bias in float32,
    returned in the compute dtype.  Parameters ``weight`` / ``bias`` and
    buffers ``running_mean`` / ``running_var``, the reference's names.

    ``process_group`` is None (the default): the statistics are this
    process's rows'.  Data-parallel training sets it
    (``parallel.set_process_group``, called by ``wrap_data_parallel``);
    the statistics are then the global batch's, as Flax computes them over
    a sharded array: the sum, the sum of squares and the row count (float32,
    exact to 2^24 rows) are summed over the group's ranks by an all-reduce
    that autograd differentiates, so every rank normalises alike and keeps
    the same running statistics, and a training forward is a collective
    that every rank of the group runs."""

    def __init__(self, features: int, momentum: float = 0.99, epsilon: float = 1e-5):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.process_group = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        xf = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            if self.process_group is not None:
                mean, mean2 = _global_moments(xf, axes, self.process_group)
            else:
                mean, mean2 = xf.mean(axes), (xf * xf).mean(axes)
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean + (1.0 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var + (1.0 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * (torch.rsqrt(var + self.epsilon) * self.weight) + self.bias
        return y.to(compute_dtype)


def _global_moments(xf: torch.Tensor, axes, group):
    """E[x] and E[x²] over ``axes`` of the rows of every rank of ``group``."""
    from torch.distributed.nn.functional import all_reduce

    c = xf.shape[-1]
    rows = xf.new_full((1,), float(xf.numel() // c))
    total = all_reduce(torch.cat([xf.sum(axes), (xf * xf).sum(axes), rows]), group=group)
    return total[:c] / total[-1], total[c:2 * c] / total[-1]


class _Layer(nn.Module):
    def __init__(self, in_features: int, out_features: int, batch_norm: bool):
        super().__init__()
        self._sequential = nn.ModuleList([Dense(in_features, out_features)]
                                         + ([BatchNorm(out_features)] if batch_norm else []))


class MLP(nn.Module):
    """Stack of Dense (+ BatchNorm) + ReLU layers: (..., in_dim) ->
    (..., widths[-1]) in ``compute_dtype``.  ``forward``'s ``post``, when
    given, follows every layer's ReLU: the pose head's dropout
    (``OutputSimple``)."""

    def __init__(self, in_dim: int, widths: Sequence[int], compute_dtype=torch.float32,
                 batch_norm: bool = False):
        super().__init__()
        dims = [in_dim, *widths]
        self._sequential = nn.ModuleList([_Layer(dims[i], dims[i + 1], batch_norm) for i in range(len(widths))])
        self.compute_dtype = compute_dtype
        self.batch_norm = bool(batch_norm)

    def dense(self, i: int) -> Dense:
        return self._sequential[i]._sequential[0]

    def __len__(self) -> int:
        return len(self._sequential)

    def forward(self, x: torch.Tensor,
                post: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
        cd = self.compute_dtype
        x = x.to(cd)
        for i in range(len(self)):
            x = self.dense(i)(x, cd)
            if self.batch_norm:
                x = self._sequential[i]._sequential[1](x, cd)
            x = torch.relu(x)
            if post is not None:
                x = post(x)
        return x
