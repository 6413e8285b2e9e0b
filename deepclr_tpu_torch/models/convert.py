"""Weight bridge: the JAX package's variables -> this package's state dict.

    cloud_features/sa{j}/scale{s}_{w,b}{i} -> _cloud_layers.0._sa{j}.mlps.{s}.layer{i}.conv.{weight,bias}
    merge/mlp/dense_{i}/{kernel,bias}      -> _merge_layers.0._embedding._conv._sequential.{i}._sequential.0.*
    output/conv/dense_{i}                  -> _merge_layers.1.conv._sequential.{i}._sequential.0.*
    output/linear/dense_{i}                -> _merge_layers.1.linear._sequential.{i}._sequential.0.*
    output/output                          -> _merge_layers.1.output.*
    loss_module/{sx,sq}                    -> _loss_layer._{sx,sq}
    loss_module/losses_{i}/{sx,sq}         -> _loss_layer.losses.{i}._{sx,sq}

and for a batch-norm MLP's layer i, beside its Dense:

    params      .../bn_{i}/{scale,bias} -> ..._sequential.{i}._sequential.1.{weight,bias}
    batch_stats .../bn_{i}/{mean,var}   -> ..._sequential.{i}._sequential.1.running_{mean,var}

Kernels are (in, out); weights here are (out, in).  The names are the
reference PyTorch DeepCLR state-dict keys, so for a model without batch
norm the JAX package's ``convert_torch_state_dict(state_dict, strict=True)``
inverts this map.  ``load_jax_feature_propagation_params`` does the same
for a ``FeaturePropagation`` module's variables (``mlp/dense_{i}``,
``mlp/bn_{i}`` -> ``mlp._sequential.{i}._sequential.{0,1}``).
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["load_jax_feature_propagation_params", "load_jax_params"]


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value, np.float32)
    return flat


def _contiguous(indices, what: str):
    indices = sorted(indices)
    if indices != list(range(len(indices))):
        raise KeyError(f"{what}: indices {indices} are not 0..{len(indices) - 1}")
    return indices


class _Tree:
    """The flattened params and batch statistics of a variables dict, with
    the strict checks: a missing entry raises KeyError, an unused one
    ValueError (``finish``)."""

    def __init__(self, variables: Mapping):
        if "params" in variables:
            extra = set(variables) - {"params", "batch_stats"}
            if extra:
                raise ValueError(f"JAX variables hold collections the weight bridge does not use: {sorted(extra)}")
            params, stats = variables["params"], variables.get("batch_stats") or {}
        else:
            params, stats = variables, {}
        self.flat = {**_flatten(params), **{f"batch_stats:{k}": v for k, v in _flatten(stats).items()}}
        self.used = set()
        self.state: Dict[str, torch.Tensor] = {}

    def take(self, key: str) -> np.ndarray:
        if key not in self.flat:
            raise KeyError(f"missing JAX parameter {key!r}")
        self.used.add(key)
        return self.flat[key]

    def put(self, key: str, value: np.ndarray) -> None:
        self.state[key] = torch.from_numpy(np.array(value, np.float32))

    def mlp(self, src: str, dst: str, required: bool) -> None:
        """An MLP's Dense layers and, where it has them, its batch norms."""
        pat = re.compile(re.escape(src) + r"/dense_(\d+)/kernel")
        layers = [int(m.group(1)) for m in map(pat.fullmatch, self.flat) if m]
        if required and not layers:
            raise KeyError(f"missing JAX parameters under {src}/")
        for i in _contiguous(layers, src):
            layer = f"{dst}._sequential.{i}._sequential."
            self.put(layer + "0.weight", self.take(f"{src}/dense_{i}/kernel").T)
            self.put(layer + "0.bias", self.take(f"{src}/dense_{i}/bias"))
            if f"{src}/bn_{i}/scale" in self.flat:
                self.put(layer + "1.weight", self.take(f"{src}/bn_{i}/scale"))
                self.put(layer + "1.bias", self.take(f"{src}/bn_{i}/bias"))
                self.put(layer + "1.running_mean", self.take(f"batch_stats:{src}/bn_{i}/mean"))
                self.put(layer + "1.running_var", self.take(f"batch_stats:{src}/bn_{i}/var"))

    def finish(self) -> Dict[str, torch.Tensor]:
        unused = sorted(set(self.flat) - self.used)
        if unused:
            raise ValueError(f"JAX parameters not used by the weight bridge: {unused}")
        return self.state


def load_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX variables (``{"params": ..., "batch_stats": ...}``, or the params
    tree alone; nested dicts of arrays) -> state dict for
    ``DeepCLR.load_state_dict``.

    Raises KeyError on a missing entry (a weight without its bias, a gap in
    layer indices, no pose head, a batch norm without its statistics) and
    ValueError on an entry the map does not use."""
    tree = _Tree(params)
    flat = tree.flat
    sa_re = re.compile(r"cloud_features/sa(\d+)/scale(\d+)_w(\d+)")
    found: Dict[int, Dict[int, set]] = {}
    for key in flat:
        m = sa_re.fullmatch(key)
        if m:
            stage, scale, layer = map(int, m.groups())
            found.setdefault(stage, {}).setdefault(scale, set()).add(layer)
    if not found:
        raise KeyError("missing JAX parameters under cloud_features/")
    for stage in _contiguous(found, "cloud_features stages"):
        for scale in _contiguous(found[stage], f"sa{stage} scales"):
            for layer in _contiguous(found[stage][scale], f"sa{stage} scale{scale} layers"):
                src = f"cloud_features/sa{stage}/scale{scale}_"
                dst = f"_cloud_layers.0._sa{stage}.mlps.{scale}.layer{layer}.conv."
                tree.put(dst + "weight", tree.take(f"{src}w{layer}").T)
                tree.put(dst + "bias", tree.take(f"{src}b{layer}"))

    tree.mlp("merge/mlp", "_merge_layers.0._embedding._conv", required=True)
    tree.mlp("output/conv", "_merge_layers.1.conv", required=True)
    tree.mlp("output/linear", "_merge_layers.1.linear", required=False)
    tree.put("_merge_layers.1.output.weight", tree.take("output/output/kernel").T)
    tree.put("_merge_layers.1.output.bias", tree.take("output/output/bias"))

    # learned weights of a TransformUncertaintyLoss, alone or inside an AccumulatedLoss
    loss_re = re.compile(r"loss_module/(?:losses_(\d+)/)?(sx|sq)")
    for key in list(flat):
        m = loss_re.fullmatch(key)
        if m:
            where = "_loss_layer." if m.group(1) is None else f"_loss_layer.losses.{m.group(1)}."
            tree.put(f"{where}_{m.group(2)}", tree.take(key))
    return tree.finish()


def load_jax_feature_propagation_params(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``FeaturePropagation``'s variables -> state dict for the port's
    ``FeaturePropagation.load_state_dict``; the same strict checks."""
    tree = _Tree(variables)
    tree.mlp("mlp", "mlp", required=True)
    return tree.finish()
