"""Weight bridge: the JAX package's parameter tree -> this package's state dict.

    cloud_features/sa{j}/scale{s}_{w,b}{i} -> _cloud_layers.0._sa{j}.mlps.{s}.layer{i}.conv.{weight,bias}
    merge/mlp/dense_{i}/{kernel,bias}      -> _merge_layers.0._embedding._conv._sequential.{i}._sequential.0.*
    output/conv/dense_{i}                  -> _merge_layers.1.conv._sequential.{i}._sequential.0.*
    output/linear/dense_{i}                -> _merge_layers.1.linear._sequential.{i}._sequential.0.*
    output/output                          -> _merge_layers.1.output.*
    loss_module/{sx,sq}                    -> _loss_layer._{sx,sq}
    loss_module/losses_{i}/{sx,sq}         -> _loss_layer.losses.{i}._{sx,sq}

Kernels are (in, out); weights here are (out, in).  The names are the
reference PyTorch DeepCLR state-dict keys, so the JAX package's
``convert_torch_state_dict(state_dict, strict=True)`` inverts this map.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["load_jax_params"]


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


def load_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``params`` (nested dict of arrays; a ``{"params": ...}`` variables
    dict is unwrapped) -> state dict for ``DeepCLR.load_state_dict``.

    Raises KeyError on a missing entry (a weight without its bias, a gap in
    layer indices, no pose head) and ValueError on an entry the map does not
    use."""
    if set(params) == {"params"}:
        params = params["params"]
    flat = _flatten(params)
    used = set()
    state: Dict[str, torch.Tensor] = {}

    def take(key: str) -> np.ndarray:
        if key not in flat:
            raise KeyError(f"missing JAX parameter {key!r}")
        used.add(key)
        return flat[key]

    def put(key: str, value: np.ndarray) -> None:
        state[key] = torch.from_numpy(np.array(value, np.float32))

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
                put(dst + "weight", take(f"{src}w{layer}").T)
                put(dst + "bias", take(f"{src}b{layer}"))

    def dense_stack(src: str, dst: str, required: bool) -> None:
        pat = re.compile(re.escape(src) + r"/dense_(\d+)/kernel")
        layers = [int(m.group(1)) for m in map(pat.fullmatch, flat) if m]
        if required and not layers:
            raise KeyError(f"missing JAX parameters under {src}/")
        for i in _contiguous(layers, src):
            put(f"{dst}._sequential.{i}._sequential.0.weight", take(f"{src}/dense_{i}/kernel").T)
            put(f"{dst}._sequential.{i}._sequential.0.bias", take(f"{src}/dense_{i}/bias"))

    dense_stack("merge/mlp", "_merge_layers.0._embedding._conv", required=True)
    dense_stack("output/conv", "_merge_layers.1.conv", required=True)
    dense_stack("output/linear", "_merge_layers.1.linear", required=False)
    put("_merge_layers.1.output.weight", take("output/output/kernel").T)
    put("_merge_layers.1.output.bias", take("output/output/bias"))

    # learned weights of a TransformUncertaintyLoss, alone or inside an AccumulatedLoss
    loss_re = re.compile(r"loss_module/(?:losses_(\d+)/)?(sx|sq)")
    for key in list(flat):
        m = loss_re.fullmatch(key)
        if m:
            where = "_loss_layer." if m.group(1) is None else f"_loss_layer.losses.{m.group(1)}."
            put(f"{where}_{m.group(2)}", take(key))

    unused = sorted(set(flat) - used)
    if unused:
        raise ValueError(f"JAX parameters not used by the weight bridge: {unused}")
    return state
