"""Label-space loss and metric functions.

Translation, rotation and dual-quaternion losses per ``LabelType``, and a
weighted sum of them built from a training config's metric list.  Every
function takes ``(source, target)`` label batches ``(B, dim)`` and a
reduction in {'none', 'mean', 'sum'}.
"""
from __future__ import annotations

import enum
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from .geometry import LabelType
from .geometry import quaternion as quat

__all__ = [
    "MetricType",
    "trans_loss",
    "trans_3d_loss",
    "dual_loss",
    "rot_loss",
    "quat_norm_loss",
    "dual_constraint_loss",
    "make_loss_fn",
    "make_metric_fns",
]

MetricFunction = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _reduce(x: torch.Tensor, reduction: Optional[str]) -> torch.Tensor:
    if reduction is None or reduction == "none":
        return x
    if reduction == "mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    raise RuntimeError(f"Unsupported reduction '{reduction}'")


def _normalize(x: torch.Tensor, label_type: LabelType, eps: float = 1e-8) -> torch.Tensor:
    if label_type == LabelType.POSE3D_QUAT:
        norm = torch.linalg.vector_norm(x[:, 3:], dim=1, keepdim=True) + eps
        return torch.cat([x[:, :3], x[:, 3:] / norm], dim=1)
    if label_type == LabelType.POSE3D_DUAL_QUAT:
        norm = torch.linalg.vector_norm(x[:, :4], dim=1, keepdim=True) + eps
        return x / norm
    raise RuntimeError("Unsupported label type for normalization")


def _pnorm(x: torch.Tensor, p: int) -> torch.Tensor:
    if p == 1:
        return torch.sum(torch.abs(x), dim=1, keepdim=True)
    if p == 2:
        # the 1e-20 keeps the gradient finite at an exact match
        return torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + 1e-20)
    return torch.sum(torch.abs(x) ** p, dim=1, keepdim=True) ** (1.0 / p)


def trans_loss(source, target, label_type: LabelType, p: int = 2,
               reduction: Optional[str] = "mean", eps: float = 1e-8):
    """Translation-component loss (the dual part for dual quaternions)."""
    if label_type in (LabelType.POSE3D_EULER, LabelType.POSE3D_QUAT):
        s, t = source[:, :3], target[:, :3]
    elif label_type == LabelType.POSE3D_DUAL_QUAT:
        s = _normalize(source, label_type, eps)[:, 4:]
        t = _normalize(target, label_type, eps)[:, 4:]
    else:
        raise RuntimeError("Unsupported label type for this loss type.")
    return _reduce(_pnorm(s - t, p), reduction)


def trans_3d_loss(source, target, label_type: LabelType, p: int = 2,
                  reduction: Optional[str] = "mean", eps: float = 1e-8):
    """Translation loss in metric xyz coordinates."""
    if label_type in (LabelType.POSE3D_EULER, LabelType.POSE3D_QUAT):
        s, t = source[:, :3], target[:, :3]
    elif label_type == LabelType.POSE3D_DUAL_QUAT:
        sn = _normalize(source, label_type, eps)
        tn = _normalize(target, label_type, eps)
        s = 2.0 * quat.qmult(sn[:, 4:], quat.qconjugate(sn[:, :4]))[:, 1:]
        t = 2.0 * quat.qmult(tn[:, 4:], quat.qconjugate(tn[:, :4]))[:, 1:]
    else:
        raise RuntimeError("Unsupported label type for this loss type.")
    return _reduce(_pnorm(s - t, p), reduction)


def dual_loss(source, target, label_type: LabelType, p: int = 2,
              reduction: Optional[str] = "mean", eps: float = 1e-8):
    """Dual-quaternion dual-part loss."""
    if label_type == LabelType.POSE3D_QUAT:
        zeros = torch.zeros_like(source[:, :1])
        s = 0.5 * quat.qmult(torch.cat([zeros, source[:, :3]], dim=1), source[:, 3:])
        t = 0.5 * quat.qmult(torch.cat([zeros, target[:, :3]], dim=1), target[:, 3:])
    elif label_type == LabelType.POSE3D_DUAL_QUAT:
        s = _normalize(source, label_type, eps)[:, 4:]
        t = _normalize(target, label_type, eps)[:, 4:]
    else:
        raise RuntimeError("Unsupported label type for this loss type")
    return _reduce(_pnorm(s - t, p), reduction)


def rot_loss(source, target, label_type: LabelType, p: int = 2,
             reduction: Optional[str] = "mean", eps: float = 1e-8):
    """Rotation-component loss (Euler angles / quaternion / real part)."""
    if label_type == LabelType.POSE3D_EULER:
        s, t = source[:, 3:], target[:, 3:]
    elif label_type == LabelType.POSE3D_QUAT:
        s = _normalize(source, label_type, eps)[:, 3:]
        t = _normalize(target, label_type, eps)[:, 3:]
    elif label_type == LabelType.POSE3D_DUAL_QUAT:
        s = _normalize(source, label_type, eps)[:, :4]
        t = _normalize(target, label_type, eps)[:, :4]
    else:
        raise RuntimeError("Unsupported label type for this loss type")
    return _reduce(_pnorm(s - t, p), reduction)


def quat_norm_loss(source, _target, label_type: LabelType, reduction: Optional[str] = "mean"):
    """(1 - ||q||)^2 regularizer on the (real) quaternion norm."""
    if label_type == LabelType.POSE3D_QUAT:
        norm = torch.linalg.vector_norm(source[:, 3:], dim=1, keepdim=True)
    elif label_type == LabelType.POSE3D_DUAL_QUAT:
        norm = torch.linalg.vector_norm(source[:, :4], dim=1, keepdim=True)
    else:
        raise RuntimeError("Unsupported label type for this loss type.")
    return _reduce((1.0 - norm) ** 2, reduction)


def dual_constraint_loss(source, _target, label_type: LabelType,
                         reduction: Optional[str] = "mean", eps: float = 1e-8):
    """Penalty on the scalar part of the recovered translation quaternion."""
    if label_type != LabelType.POSE3D_DUAL_QUAT:
        raise RuntimeError("Unsupported label type for this loss type.")
    s = _normalize(source, label_type, eps)
    tq = 2.0 * quat.qmult(s[:, 4:], quat.qconjugate(s[:, :4]))
    return _reduce(tq[:, :1] ** 2, reduction)


class MetricType(enum.Enum):
    """Every composable loss / metric kind."""

    MAE = "mae"
    MSE = "mse"
    TRANS = "trans"
    TRANS_3D = "trans_3d"
    DUAL = "dual"
    ROT = "rot"
    QUAT_NORM = "quat_norm"
    DUAL_CONSTRAINT = "dual_constraint"

    @classmethod
    def create(cls, value) -> "MetricType":
        if isinstance(value, cls):
            return value
        return cls(str(value).lower())

    def fn(self, label_type: LabelType, weights: Optional[Sequence[float]] = None,
           **kwargs: Any) -> MetricFunction:
        """The metric as ``f(source, target)``: the mean over the batch, or,
        with ``weights``, the weighted sum of its per-component batch means."""

        def generic(source, target, reduction):
            if self == MetricType.MAE:
                return _reduce(torch.abs(source - target), reduction)
            if self == MetricType.MSE:
                return _reduce((source - target) ** 2, reduction)
            if self == MetricType.TRANS:
                return trans_loss(source, target, label_type, reduction=reduction, **kwargs)
            if self == MetricType.TRANS_3D:
                return trans_3d_loss(source, target, label_type, reduction=reduction, **kwargs)
            if self == MetricType.DUAL:
                return dual_loss(source, target, label_type, reduction=reduction, **kwargs)
            if self == MetricType.ROT:
                return rot_loss(source, target, label_type, reduction=reduction, **kwargs)
            if self == MetricType.QUAT_NORM:
                return quat_norm_loss(source, target, label_type, reduction=reduction)
            return dual_constraint_loss(source, target, label_type, reduction=reduction)

        if weights is None:
            return lambda s, t: generic(s, t, "mean")
        w = torch.tensor(list(weights), dtype=torch.float32)
        return lambda s, t: torch.sum(w.to(s.device) * torch.mean(generic(s, t, "none"), dim=0))


def make_loss_fn(loss_cfgs: Sequence[Dict], label_type: LabelType) -> MetricFunction:
    """Weighted-sum loss from a config metric list; each entry is
    {'type': str | MetricType, 'weights': [..], 'params': {..}}."""
    label_type = LabelType.create(label_type)
    fns = []
    for m in loss_cfgs:
        params = m.get("params", {}) or {}
        fns.append(MetricType.create(m["type"]).fn(label_type, weights=m.get("weights", [1.0]), **params))

    def loss_fn(source, target):
        return sum(f(source, target) for f in fns)

    return loss_fn


def make_metric_fns(loss_cfgs: Sequence[Dict], other_cfgs: Sequence[Dict],
                    label_type: LabelType) -> Dict[str, MetricFunction]:
    """Named unweighted metric functions for logging."""
    label_type = LabelType.create(label_type)
    out: Dict[str, MetricFunction] = {}
    for m in [*loss_cfgs, *other_cfgs]:
        mt = MetricType.create(m["type"])
        out[mt.value] = mt.fn(label_type, **(m.get("params", {}) or {}))
    return out
