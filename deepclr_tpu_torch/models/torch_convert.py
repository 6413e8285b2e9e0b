"""Reference (PyTorch DeepCLR) checkpoints -> this package's state dict.

The reference ships ``weights.tar`` (a state dict) and ``ckpt.tar`` (a dict
holding it under ``model_state_dict``), both ``torch.save`` archives.  Its
layers are 1x1 convolutions, so a weight is (out, in, 1[, 1]) where this
package keeps (out, in).  The names are otherwise this package's:

    _cloud_layers.{k}._sa{j}.mlps.{s}.layer{i}.conv.{weight,bias}
        -> _cloud_layers.0._sa{j}.mlps.{s}.layer{i}.conv.*
    {mlp}._sequential.{i}._sequential.0.{weight,bias}          (convolution)
    {mlp}._sequential.{i}._sequential.1.{weight,bias,running_mean,running_var}
        (batch norm; its num_batches_tracked is dropped)
        for {mlp} in _merge_layers.0._embedding._conv, _merge_layers.1.conv,
        _merge_layers.1.linear; the layer indices are compacted in order,
        since the reference's Dropout modules take indices of their own
    _merge_layers.1.output.{weight,bias}
    _loss_layer._{sx,sq}, _loss_layer.losses.{i}._{sx,sq}
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

__all__ = ["convert_reference_state_dict", "load_reference_checkpoint"]

_MLPS = ("_merge_layers.0._embedding._conv", "_merge_layers.1.conv", "_merge_layers.1.linear")
_SA = re.compile(r"_cloud_layers\.\d+\.(_sa\d+\.mlps\.\d+\.layer\d+\.conv\.(?:weight|bias))")
_BN_DROPPED = "num_batches_tracked"


def _dense(w: torch.Tensor) -> torch.Tensor:
    """A (out, in, 1[, 1]) convolution or (out, in) linear weight -> (out, in)."""
    if w.dim() < 2 or any(d != 1 for d in w.shape[2:]):
        raise ValueError(f"not a 1x1 convolution or linear weight: shape {tuple(w.shape)}")
    return w.reshape(w.shape[0], w.shape[1])


def convert_reference_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference state dict -> a state dict for ``DeepCLR.load_state_dict``
    (float32).  Raises ValueError on an entry the map does not use."""
    used = set()
    out: Dict[str, torch.Tensor] = {}

    def put(dst: str, src: str, dense: bool = False) -> None:
        used.add(src)
        value = torch.as_tensor(state_dict[src]).detach().to(torch.float32)
        out[dst] = _dense(value) if dense else value

    for key in state_dict:
        m = _SA.fullmatch(key)
        if m:
            put(f"_cloud_layers.0.{m.group(1)}", key, dense=key.endswith("weight"))

    for prefix in _MLPS:
        pat = re.compile(re.escape(prefix) + r"\._sequential\.(\d+)\._sequential\.([01])\.(\w+)")
        layers: Dict[int, Dict[str, str]] = {}
        for key in state_dict:
            m = pat.fullmatch(key)
            if m:
                layers.setdefault(int(m.group(1)), {})[f"{m.group(2)}.{m.group(3)}"] = key
        for i, raw in enumerate(sorted(layers)):
            for name, key in layers[raw].items():
                if name == f"1.{_BN_DROPPED}":
                    used.add(key)
                elif name in ("0.weight", "0.bias", "1.weight", "1.bias", "1.running_mean", "1.running_var"):
                    put(f"{prefix}._sequential.{i}._sequential.{name}", key, dense=name == "0.weight")

    for name in ("weight", "bias"):
        key = f"_merge_layers.1.output.{name}"
        if key in state_dict:
            put(key, key, dense=name == "weight")

    loss_re = re.compile(r"_loss_layer\.(?:losses\.\d+\.)?_s[xq]")
    for key in state_dict:
        if loss_re.fullmatch(key):
            put(key, key)

    unused = sorted(set(state_dict) - used)
    if unused:
        raise ValueError(f"reference state-dict entries not used by the name map: {unused}")
    return out


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``weights.tar`` or ``ckpt.tar`` -> this package's state dict."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(data, Mapping) and "model_state_dict" in data:
        data = data["model_state_dict"]
    if not isinstance(data, Mapping):
        raise ValueError(f"{path}: holds no state dict")
    return convert_reference_state_dict(data)
