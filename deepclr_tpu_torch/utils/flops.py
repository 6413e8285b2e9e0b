"""Analytic FLOP accounting for the DeepCLR forward pass, and model FLOPs
utilization on the card (the JAX package's ``utils/flops.py``).

``model_flops_per_pair`` counts the *algorithmic* forward FLOPs of one
cloud-pair registration under the reference's semantics (nsample-capped
balls, k-NN motion embedding, exact MLP widths): the same integers as the
JAX package.  It is the useful-work numerator of MFU; the kernels execute
more (the fused set abstraction visits every in-radius point), so MFU here
says how close the delivered registration rate comes to what the card's
peak could sustain on the minimum math.

Peaks are dense bf16 FLOP/s of the card, from the vendor's data sheet; a
card not in the table raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["model_flops_per_pair", "peak_flops_per_chip", "mfu"]

# dense bf16 peak per card, FLOP/s, by torch.cuda.get_device_name()
_PEAKS: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989e12,  # H100 SXM
}


def _mlp_macs(rows: int, dims) -> int:
    return sum(rows * dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def _plain(cfg):
    """Config tree -> plain nested dict (accepts dicts unchanged)."""
    if isinstance(cfg, dict):
        return cfg
    if hasattr(cfg, "to_dict"):
        return cfg.to_dict()
    return dict(cfg)


def model_flops_per_pair(model_cfg, num_points: int = 16384) -> float:
    """Algorithmic forward FLOPs (multiply+add = 2 FLOPs) for ONE pair."""
    cfg = _plain(model_cfg)
    params = _plain(cfg["params"])
    feat_dim = int(cfg.get("input_dim", 3)) - 3

    macs = 0
    cf = _plain(_plain(params["cloud_features"])["params"])
    n = num_points
    out_feat = 0
    for stage in range(len(cf["npoint"])):
        p = int(cf["npoint"][stage])
        cin = feat_dim if stage == 0 else out_feat
        out_feat = 0
        for ns, widths in zip(cf["nsamples"][stage], cf["mlps"][stage]):
            # SharedMLP over the grouped (P, nsample) tensor: every layer
            # (incl. layer 1) runs once per (center, sample)
            macs += _mlp_macs(p * int(ns), [3 + cin] + list(widths))
            out_feat += widths[-1]
        n = p
    macs *= 2  # two clouds encoded per pair

    # motion embedding: kNN distances + per-(center, k-neighbor) MLP
    mg = _plain(_plain(params["merge"])["params"])
    k = int(mg["k"])
    merge_mlp = list(mg["mlp"])
    p = n
    macs += p * p * 3  # kNN cross-term distances (template x source)
    macs += _mlp_macs(p * k, [3 + out_feat * 2] + merge_mlp)

    # output head: conv MLP over P motion features + global max + FC stack
    out = _plain(_plain(params["output"])["params"])
    macs += _mlp_macs(p, [3 + merge_mlp[-1]] + list(out["mlp"]))
    macs += _mlp_macs(1, list(out["linear"]))
    macs += list(out["linear"])[-1] * 8  # final label layer (dual quat)

    return 2.0 * macs


def peak_flops_per_chip(device_name: Optional[str] = None) -> float:
    """Dense bf16 peak of the card named ``device_name`` (default: CUDA
    device 0's name); raises for a card the table does not hold, and when
    no card is present and no name is given."""
    if device_name is None:
        if not torch.cuda.is_available():
            raise RuntimeError("peak_flops_per_chip: no CUDA device")
        device_name = torch.cuda.get_device_name(0)
    if device_name not in _PEAKS:
        raise ValueError(f"peak_flops_per_chip: no peak known for {device_name!r}")
    return _PEAKS[device_name]


def mfu(pairs_per_sec: float, model_cfg, num_points: int = 16384, device_name: Optional[str] = None) -> float:
    """Model FLOPs utilization: delivered algorithmic FLOP/s over the
    card's peak."""
    return pairs_per_sec * model_flops_per_pair(model_cfg, num_points) / peak_flops_per_chip(device_name)
