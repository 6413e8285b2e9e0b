"""DeepCLR network: per-cloud PointNet++ set abstraction -> cross-cloud
motion embedding (kNN grouping) -> mini-PointNet pose head.

Clouds are fixed-shape padded tensors with validity masks.  ``encode`` and
``register`` split the forward so sequential odometry encodes each frame
once; ``forward`` encodes template and source as one stacked batch of 2B
clouds.  Module names follow the reference PyTorch DeepCLR state dict
(``_cloud_layers.0._sa{j}``, ``_merge_layers.0._embedding._conv``,
``_merge_layers.1.{conv,linear,output}``), so ``models.convert`` maps the
JAX package's parameters onto them one to one.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .. import ops
from ..geometry import LabelType, se3
from ..losses import rot_loss, trans_loss
from .layers import MLP, Dense
from .pointnet2 import SetAbstractionMSG

__all__ = ["SetAbstraction", "MotionEmbedding", "OutputSimple", "TransformLoss",
           "TransformUncertaintyLoss", "AccumulatedLoss", "DeepCLR"]


class SetAbstraction(nn.Module):
    """1-2 stacked MSG set-abstraction stages.  Config lists are indexed by
    stage, e.g. npoint=[1024], radii=[[0.5, 1.0]], nsamples=[[512, 1024]],
    mlps=[[[16, 16, 32], [16, 16, 32]]].  ``nsamples`` caps the ball only on
    the exact (index-based) path, which this package does not have.
    ``presorted``: the input is Morton-ordered by the host, so stage 0 skips
    its point sort (later stages take FPS centres, never host-ordered)."""

    def __init__(self, input_dim: int, npoint: Sequence[int], radii, nsamples, mlps,
                 batch_norm: bool = False, compute_dtype=torch.float32, presorted: bool = False):
        super().__init__()
        if not len(npoint) == len(radii) == len(nsamples) == len(mlps) or not 0 < len(npoint) <= 2:
            raise ValueError("SetAbstraction: 1-2 stages with one entry per stage in every list")
        if batch_norm:
            raise NotImplementedError("batch_norm in SetAbstraction is not supported by the fused path")
        self.num_stages = len(npoint)
        self.presorted = bool(presorted)
        in_dim = input_dim
        for stage in range(self.num_stages):
            sa = SetAbstractionMSG(in_dim, npoint[stage], radii[stage], mlps[stage],
                                   compute_dtype=compute_dtype, presorted=self.presorted and stage == 0)
            self.add_module(f"_sa{stage}", sa)
            in_dim = 3 + sa.out_dim

    @property
    def out_dim(self) -> int:
        return 3 + getattr(self, f"_sa{self.num_stages - 1}").out_dim

    def forward(self, points: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """points (B, N, D) xyz+features, mask (B, N) -> (B, P, 3+F)."""
        xyz = points[..., :3]
        features = points[..., 3:] if points.shape[-1] > 3 else None
        for stage in range(self.num_stages):
            xyz, features = getattr(self, f"_sa{stage}")(xyz, features, mask)
            # every centre is a real point, so later stages need no mask
            mask = None
        return torch.cat([xyz, features], dim=-1)


class _Embedding(nn.Module):
    def __init__(self, in_dim: int, mlp: Sequence[int], compute_dtype):
        super().__init__()
        self._conv = MLP(in_dim, mlp, compute_dtype)


class MotionEmbedding(nn.Module):
    """Cross-cloud motion embedding.  For each template point: its k nearest
    source points, per-pair features [Δpos | f_template | f_source] through
    a shared MLP, neighbours at or beyond ``radius`` zeroed (radius > 0),
    max over neighbours.  Output: template xyz ‖ feature.

    Layer 1 is affine in [Δpos | f0 | f1], so it splits into a per-source
    term A_j = x_j·Wd + f1_j·Wf + b and a per-template term
    B_p = f0_p·W0 − c_p·Wd; the neighbour gather moves after the first
    matmul.  Layer 1 runs in float32 (the split subtracts large absolute
    coordinates, which bf16 cannot cancel); the tail runs in compute_dtype
    with results in compute_dtype.  The radius mask reuses the kNN d².
    """

    def __init__(self, feat_dim: int, mlp: Sequence[int], k: int = 20, radius: float = 10.0,
                 point_dim: int = 3, batch_norm: bool = False, compute_dtype=torch.float32):
        super().__init__()
        if batch_norm:
            raise NotImplementedError("the batch-norm MotionEmbedding path is not ported")
        if k < 1:
            raise NotImplementedError("MotionEmbedding with k=0 (all source points) is not ported")
        self.k = int(k)
        self.radius = float(radius)
        self.point_dim = point_dim
        self._embedding = _Embedding(point_dim + 2 * feat_dim, mlp, compute_dtype)
        self.compute_dtype = compute_dtype

    @property
    def mlp(self) -> MLP:
        return self._embedding._conv

    def forward(self, feats0: torch.Tensor, feats1: torch.Tensor) -> torch.Tensor:
        """feats0 (template), feats1 (source): (B, P, 3+C) -> (B, P, 3+F)."""
        pd = self.point_dim
        xyz0, f0 = feats0[..., :pd], feats0[..., pd:]
        xyz1, f1 = feats1[..., :pd], feats1[..., pd:]
        idx, nbr_d2 = ops.knn(xyz0.detach(), xyz1.detach(), self.k)

        dense0 = self.mlp.dense(0)
        w1 = dense0.weight.t()  # (in, out), float32
        wd, w0, wf = w1[:pd], w1[pd:pd + f0.shape[-1]], w1[pd + f0.shape[-1]:]
        a = torch.matmul(xyz1, wd) + torch.matmul(f1, wf) + dense0.bias
        bp = torch.matmul(f0, w0) - torch.matmul(xyz0, wd)
        h = torch.relu(ops.group_points(a, idx) + bp[:, :, None, :])  # (B, P, k, H1)
        beyond = (nbr_d2 >= self.radius * self.radius)[..., None]

        cd = self.compute_dtype
        h = h.to(cd)
        for i in range(1, len(self.mlp)):
            h = torch.relu(self.mlp.dense(i)(h, cd))
        if self.radius > 0.0:
            h = torch.where(beyond, torch.zeros_like(h), h)
        feat = torch.amax(h, dim=-2).float()
        return torch.cat([xyz0, feat], dim=-1)


class OutputSimple(nn.Module):
    """Mini-PointNet + FC pose head.  ``linear[0]`` is the input width
    (== mlp[-1]), not a layer.  Label-specific activations keep the rotation
    bounded: for dual quaternions sigmoid on the real scalar part and tanh
    on the real vector part; the pose Dense runs in float32.

    ``dropout_keep`` < 1 is the reference's dropout (``layers.py`` MLP with
    ``dropout_last=True``): in training mode, inverted dropout after the
    ReLU of every ``linear`` layer, the last one included; an element is
    kept with probability ``dropout_keep`` and scaled by 1/``dropout_keep``.
    The masks come from the head's own ``torch.Generator`` on its device,
    never from the global generator.  ``seed_dropout(step)`` seeds it from
    (``dropout_seed``, step), as the reference folds the step into its key,
    so a run resumed at a step draws the masks an uninterrupted run draws
    there; the train step calls it before every forward.  Eval mode drops
    nothing."""

    def __init__(self, in_dim: int, mlp: Sequence[int], linear: Sequence[int],
                 label_type: LabelType, batch_norm: bool = False, dropout_keep: float = 1.0,
                 compute_dtype=torch.float32, dropout_seed: int = 0):
        super().__init__()
        if batch_norm:
            raise NotImplementedError("batch_norm in OutputSimple is not ported")
        self.label_type = label_type
        self.dropout_keep = float(dropout_keep)
        self.dropout_seed = int(dropout_seed)
        self._dropout_gen: Optional[torch.Generator] = None
        self.conv = MLP(in_dim, mlp, compute_dtype)
        self.linear = MLP(linear[0], linear[1:], compute_dtype)
        self.output = Dense(linear[-1], label_type.dim, bias_value=label_type.bias)

    def seed_dropout(self, step: int) -> None:
        """Seed the masks of the next training forwards from
        (``dropout_seed``, ``step``)."""
        dev = self.output.weight.device
        if self._dropout_gen is None or self._dropout_gen.device != dev:
            self._dropout_gen = torch.Generator(device=dev)
        self._dropout_gen.manual_seed((self.dropout_seed * 2**32 + int(step)) % 2**64)

    def _dropout(self, h: torch.Tensor) -> torch.Tensor:
        if self._dropout_gen is None or self._dropout_gen.device != h.device:
            self.seed_dropout(0)
        keep = torch.rand(h.shape, generator=self._dropout_gen, device=h.device) < self.dropout_keep
        return torch.where(keep, h / self.dropout_keep, torch.zeros_like(h))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, P, D) -> the ``linear`` stack's output (B, linear[-1]) in the
        compute dtype, dropped out in training mode."""
        h = torch.amax(self.conv(x), dim=-2)
        drop = self.training and self.dropout_keep < 1.0
        return self.linear(h, self._dropout if drop else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, P, D) -> (B, label_type.dim) float32."""
        h = self.features(x)
        y = self.output(h.float(), torch.float32)
        if self.label_type == LabelType.POSE3D_QUAT:
            y = torch.cat([y[:, :3], torch.sigmoid(y[:, 3:4]), torch.tanh(y[:, 4:])], dim=1)
        elif self.label_type == LabelType.POSE3D_DUAL_QUAT:
            y = torch.cat([torch.sigmoid(y[:, 0:1]), torch.tanh(y[:, 1:4]), y[:, 4:]], dim=1)
        return y


class TransformLoss(nn.Module):
    """Fixed-weight translation + rotation loss."""

    def __init__(self, label_type: LabelType, p: int = 2, sx: float = 1.0, sq: float = 1.0):
        super().__init__()
        self.label_type, self.p, self.sx, self.sq = label_type, int(p), float(sx), float(sq)

    def forward(self, y_pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        p_loss = trans_loss(y_pred, y, self.label_type, p=self.p, reduction="mean")
        q_loss = rot_loss(y_pred, y, self.label_type, p=self.p, reduction="mean")
        return p_loss * self.sx + q_loss * self.sq


class TransformUncertaintyLoss(nn.Module):
    """Homoscedastic-uncertainty weighting (Kendall) with learned log-variances
    ``sx`` and ``sq``, (1,) parameters initialised from the config.  They are
    stored as ``_sx`` / ``_sq``, the reference state-dict names."""

    def __init__(self, label_type: LabelType, p: int = 2, sx: float = 0.0, sq: float = 0.0):
        super().__init__()
        self.label_type, self.p = label_type, int(p)
        self._sx = nn.Parameter(torch.tensor([float(sx)]))
        self._sq = nn.Parameter(torch.tensor([float(sq)]))

    def forward(self, y_pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        p_loss = trans_loss(y_pred, y, self.label_type, p=self.p, reduction="mean")
        q_loss = rot_loss(y_pred, y, self.label_type, p=self.p, reduction="mean")
        sx, sq = self._sx, self._sq
        return torch.sum(p_loss * torch.exp(-sx) + sx + q_loss * torch.exp(-sq) + sq)


class AccumulatedLoss(nn.Module):
    """Sum of several loss modules."""

    def __init__(self, losses: Sequence[nn.Module]):
        super().__init__()
        self.losses = nn.ModuleList(losses)

    def forward(self, y_pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return sum(loss(y_pred, y) for loss in self.losses)


class DeepCLR(nn.Module):
    """End-to-end correspondence-less registration network.

    * ``encode``: per-cloud features (SetAbstraction), once per LiDAR frame
      in sequential odometry;
    * ``register``: motion embedding + pose head on two encoded clouds;
    * ``encode_register``: one sequential step, encode a new frame and
      register it against the cached previous features;
    * ``forward``: encode template and source as one stacked 2B batch and
      register; returns ``(y_pred, loss)``, the loss from ``loss_module``
      when the model has one and labels ``y`` are given, else None.
    """

    def __init__(self, cloud_features: SetAbstraction, merge: MotionEmbedding,
                 output: OutputSimple, input_dim: int = 4, point_dim: int = 3,
                 label_type: LabelType = LabelType.POSE3D_DUAL_QUAT,
                 loss_module: Optional[nn.Module] = None):
        super().__init__()
        self._cloud_layers = nn.ModuleList([cloud_features])
        self._merge_layers = nn.ModuleList([merge, output])
        # the reference state dict keeps the loss under ``_loss_layer``
        self._loss_layer = loss_module
        self.input_dim = input_dim
        self.point_dim = point_dim
        self.label_type = label_type

    @property
    def cloud_features(self) -> SetAbstraction:
        return self._cloud_layers[0]

    @property
    def merge(self) -> MotionEmbedding:
        return self._merge_layers[0]

    @property
    def output(self) -> OutputSimple:
        return self._merge_layers[1]

    @property
    def loss_module(self) -> Optional[nn.Module]:
        return self._loss_layer

    def encode(self, points: torch.Tensor, mask: Optional[torch.Tensor] = None,
               aug: Optional[torch.Tensor] = None) -> torch.Tensor:
        """points (B, N, D); aug: optional (B, 4, 4) transforms applied to
        the first point_dim dims."""
        if aug is not None:
            pd = self.point_dim
            xyz = se3.transform_points(aug, points[..., :pd])
            points = torch.cat([xyz, points[..., pd:]], dim=-1)
        return self.cloud_features(points, mask)

    def register(self, feats0: torch.Tensor, feats1: torch.Tensor) -> torch.Tensor:
        """Encoded template/source (B, P, 3+C) -> predicted label (B, dim)."""
        return self.output(self.merge(feats0, feats1))

    def encode_register(self, feats0: torch.Tensor, points: torch.Tensor,
                        mask: Optional[torch.Tensor] = None):
        """Encode one new frame and register it against the cached
        previous-frame features.  Returns (y_pred, feats1)."""
        feats1 = self.encode(points, mask)
        return self.register(feats0, feats1), feats1

    def forward(self, template: torch.Tensor, source: torch.Tensor,
                template_mask: Optional[torch.Tensor] = None,
                source_mask: Optional[torch.Tensor] = None,
                aug_template: Optional[torch.Tensor] = None,
                aug_source: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None):
        """Pairwise registration of equally padded clouds -> (y_pred (B, dim),
        loss or None)."""
        if template.shape != source.shape:
            raise ValueError(f"template {tuple(template.shape)} and source {tuple(source.shape)} "
                             "must be padded to one shape")
        # one stacked 2B encode: every encode op is per cloud, so this halves
        # the kernel launches and changes no value
        b = template.shape[0]
        both = torch.cat([template, source], dim=0)
        mask = None
        if template_mask is not None or source_mask is not None:
            ones = torch.ones(template.shape[:2], dtype=torch.bool, device=template.device)
            mask = torch.cat([ones if template_mask is None else template_mask,
                              ones if source_mask is None else source_mask], dim=0)
        aug = None
        if aug_template is not None or aug_source is not None:
            eye = torch.eye(4, dtype=torch.float32, device=template.device).expand(b, 4, 4)
            aug = torch.cat([eye if aug_template is None else aug_template,
                             eye if aug_source is None else aug_source], dim=0)
        feats = self.encode(both, mask, aug)
        y_pred = self.register(feats[:b], feats[b:])
        loss = None
        if self.loss_module is not None and y is not None:
            loss = self.loss_module(y_pred, y)
        return y_pred, loss
