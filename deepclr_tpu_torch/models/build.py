"""Model construction from the reference model-config schema, a seeded
parameter initialization, and the model's weights file (``weights.pt``, the
state dict that ``engine.checkpoint`` writes)."""
from __future__ import annotations

import enum
import os
import os.path as osp
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device, strict_float32
from ..geometry import LabelType
from .deepclr import (AccumulatedLoss, DeepCLR, MotionEmbedding, OutputSimple, SetAbstraction,
                      TransformLoss, TransformUncertaintyLoss)
from .layers import Dense

__all__ = ["ModelType", "build_model", "init_params", "load_trained_model", "load_weights", "save_weights"]


class ModelType(enum.Enum):
    DEEPCLR = "deepclr"

    @classmethod
    def create(cls, value) -> "ModelType":
        if isinstance(value, cls):
            return value
        return cls(str(value).lower())


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_LOSSES = {"TransformLoss": TransformLoss, "TransformUncertaintyLoss": TransformUncertaintyLoss}


def _section(params: dict, key: str, name: str) -> dict:
    sec = params[key]
    if sec["name"] != name:
        raise NotImplementedError(f"{key}: {sec['name']} is not ported")
    return dict(sec.get("params", {}))


def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Draw every parameter anew from a ``torch.Generator`` seeded with
    ``seed``, in module order, on the CPU (so a seed gives the same weights on
    any device): He-normal SA weights, Xavier-uniform MLP and head weights,
    zero biases except the head's identity bias."""
    gen = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, Dense):
            module.reset_parameters(gen)
    return model


def _loss_module(loss_cfg, label_type: LabelType):
    """The in-model loss: one loss config, or a list summed by AccumulatedLoss."""
    if loss_cfg is None:
        return None

    def make(lc):
        if lc["name"] not in _LOSSES:
            raise NotImplementedError(f"loss {lc['name']} is not ported")
        return _LOSSES[lc["name"]](label_type=label_type, **dict(lc.get("params") or {}))

    if isinstance(loss_cfg, (list, tuple)):
        return AccumulatedLoss([make(lc) for lc in loss_cfg])
    return make(loss_cfg)


def build_model(model_cfg, device="cuda", seed: int = 0) -> DeepCLR:
    """Build DeepCLR from a model config dict or ``Config`` tree (input_dim,
    point_dim, label_type, model_type, params{batch_norm, dropout,
    compute_dtype, presorted, cloud_features, merge, output[, loss]}),
    initialize it from ``seed`` and put it in eval mode on ``device``.
    ``seed`` also seeds the pose head's dropout generator.  Runs on CUDA
    unless ``device='cpu'``; raises when CUDA is asked for and absent."""
    device = resolve_device(device)
    strict_float32()
    if hasattr(model_cfg, "to_dict"):
        model_cfg = model_cfg.to_dict()
    ModelType.create(model_cfg.get("model_type", "deepclr"))  # raises on an unknown model type
    label_type = LabelType.create(model_cfg["label_type"])
    input_dim = int(model_cfg.get("input_dim", 3))
    point_dim = int(model_cfg.get("point_dim", 3))
    params = dict(model_cfg.get("params") or {})
    if not params.get("fused", True):
        raise NotImplementedError("the exact (ball_query) SA path is not ported")
    common = dict(batch_norm=bool(params.get("batch_norm", False)),
                  compute_dtype=_DTYPES[str(params.get("compute_dtype", "float32"))])

    cloud_features = SetAbstraction(input_dim, **_section(params, "cloud_features", "SetAbstraction"),
                                    presorted=bool(params.get("presorted", False)), **common)
    merge = MotionEmbedding(cloud_features.out_dim - point_dim, point_dim=point_dim,
                            **_section(params, "merge", "MotionEmbedding"), **common)
    mlp_out = merge.mlp.dense(len(merge.mlp) - 1).weight.shape[0]
    output = OutputSimple(point_dim + mlp_out, label_type=label_type,
                          dropout_keep=float(params.get("dropout", 1.0)), dropout_seed=seed,
                          **_section(params, "output", "OutputSimple"), **common)
    model = DeepCLR(cloud_features, merge, output, input_dim=input_dim, point_dim=point_dim,
                    label_type=label_type, loss_module=_loss_module(params.get("loss"), label_type))
    init_params(model, seed)
    return model.to(device).eval()


def save_weights(path: str, model: nn.Module) -> None:
    """Write the model's state dict to ``path`` (through a temporary file)."""
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, tmp)
    os.replace(tmp, path)


def load_weights(path: str, model: nn.Module) -> nn.Module:
    """Load a state dict written by ``save_weights`` (or a ``weights_*.pt``
    of a checkpoint) into ``model``, every key required; returns the model."""
    device = next(model.parameters()).device
    model.load_state_dict(torch.load(path, map_location=device, weights_only=True), strict=True)
    return model


def load_trained_model(model_cfg, weights_path: Optional[str] = None, device="cuda",
                       seed: int = 0) -> DeepCLR:
    """Build the model and load its weights from ``weights_path``, else from
    the config's ``weights`` entry; with neither, the model keeps its seeded
    initialization (timing runs with untrained models).  A weights path
    that names no file raises."""
    model = build_model(model_cfg, device=device, seed=seed)
    cfg = model_cfg.to_dict() if hasattr(model_cfg, "to_dict") else model_cfg
    weights_path = weights_path or cfg.get("weights")
    if weights_path is None:
        return model
    if not osp.isfile(str(weights_path)):
        raise FileNotFoundError(f"model weights not found: {weights_path}")
    return load_weights(str(weights_path), model)
