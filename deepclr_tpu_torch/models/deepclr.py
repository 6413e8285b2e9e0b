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
import torch.distributed as dist
from torch import nn

from .. import ops
from ..geometry import LabelType, se3
from ..losses import rot_loss, trans_loss
from ..ops.pairwise import _sqnorm
from ..utils.profiling import count, span
from .layers import MLP, Dense
from .pointnet2 import SetAbstractionMSG

__all__ = ["SetAbstraction", "MotionEmbedding", "OutputSimple", "TransformLoss",
           "TransformUncertaintyLoss", "AccumulatedLoss", "DeepCLR"]


class SetAbstraction(nn.Module):
    """1-2 stacked MSG set-abstraction stages.  Config lists are indexed by
    stage, e.g. npoint=[1024], radii=[[0.5, 1.0]], nsamples=[[512, 1024]],
    mlps=[[[16, 16, 32], [16, 16, 32]]].  ``fused``: the fused kernels (the
    full ball), else the exact path (``nsamples`` caps the ball; see
    ``pointnet2``).  ``presorted``: the input is Morton-ordered by the host,
    so stage 0 skips its point sort (later stages take FPS centres, never
    host-ordered).  Batch norm raises on both paths, as in the JAX package."""

    def __init__(self, input_dim: int, npoint: Sequence[int], radii, nsamples, mlps,
                 batch_norm: bool = False, compute_dtype=torch.float32, presorted: bool = False,
                 fused: bool = True):
        super().__init__()
        if not len(npoint) == len(radii) == len(nsamples) == len(mlps) or not 0 < len(npoint) <= 2:
            raise ValueError("SetAbstraction: 1-2 stages with one entry per stage in every list")
        if batch_norm:
            raise NotImplementedError("batch_norm in SetAbstraction is not supported (nor by the JAX package)")
        self.num_stages = len(npoint)
        self.presorted = bool(presorted)
        self.fused = bool(fused)
        in_dim = input_dim
        for stage in range(self.num_stages):
            sa = SetAbstractionMSG(in_dim, npoint[stage], radii[stage], mlps[stage],
                                   compute_dtype=compute_dtype, presorted=self.presorted and stage == 0,
                                   nsamples=nsamples[stage], fused=self.fused)
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
    def __init__(self, in_dim: int, mlp: Sequence[int], compute_dtype, batch_norm: bool):
        super().__init__()
        self._conv = MLP(in_dim, mlp, compute_dtype, batch_norm=batch_norm)


_GATHERS = ("auto", "take", "onehot")


class MotionEmbedding(nn.Module):
    """Cross-cloud motion embedding.  For each template point: its k nearest
    source points (k = 0: every source point), per-pair features
    [Δpos | f_template | f_source] (``append_features``; else
    [Δpos | f_source − f_template]) through a shared MLP, pairs at or
    beyond ``radius`` zeroed (radius > 0), max over the neighbours.  Output:
    template xyz ‖ feature.

    Without batch norm, layer 1 is affine in the pair features, so it splits
    into a per-source term A_j = x_j·Wd + f1_j·Wf + b and a per-template
    term B_p = f0_p·W0 − c_p·Wd, and the neighbour gather moves after the
    first matmul.  Layer 1 runs in float32 (the split subtracts large
    absolute coordinates, which bf16 cannot cancel); the tail runs in
    compute_dtype with results in compute_dtype.  The k-NN radius mask
    reuses the kNN d²; for k = 0 it is ‖Δpos‖ ≥ radius, as in the JAX
    package.  ``gather`` picks how the A rows are gathered: "take" (an
    index gather; "auto" is "take" off a TPU) or "onehot" (the JAX
    package's TPU form: one-hot bf16 products with the rows split into
    hi + lo bf16 halves).  With batch norm the pair features are built
    literally and go through the MLP (Dense -> BatchNorm -> ReLU).

    With a radius, each forward counts its neighbour pairs as
    ``merge.pairs`` and those it zeroes as ``merge.cut``
    (``utils.profiling.count``: while spans are on)."""

    def __init__(self, feat_dim: int, mlp: Sequence[int], k: int = 20, radius: float = 10.0,
                 point_dim: int = 3, append_features: bool = True, batch_norm: bool = False,
                 compute_dtype=torch.float32, gather: str = "auto"):
        super().__init__()
        if k < 0:
            raise ValueError(f"k must be >= 0, got {k}")
        if gather not in _GATHERS:
            raise ValueError(f"Unknown gather mode: {gather!r}")
        self.k = int(k)
        self.radius = float(radius)
        self.point_dim = point_dim
        self.append_features = bool(append_features)
        self.batch_norm = bool(batch_norm)
        self.gather = gather
        in_dim = point_dim + (2 * feat_dim if self.append_features else feat_dim)
        self._embedding = _Embedding(in_dim, mlp, compute_dtype, self.batch_norm)
        self.compute_dtype = compute_dtype

    @property
    def mlp(self) -> MLP:
        return self._embedding._conv

    def _gather_rows(self, a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """(B, N, H1) rows, (B, P, k) indices -> (B, P, k, H1) float32."""
        if self.gather != "onehot":
            return ops.group_points(a, idx)
        b, nsrc, h1 = a.shape
        _, p, k = idx.shape
        onehot = (idx.reshape(b, p * k, 1) == torch.arange(nsrc, device=a.device)).to(torch.bfloat16)
        a_hi = a.to(torch.bfloat16)
        a_lo = (a - a_hi.float()).to(torch.bfloat16)
        # each product selects one bf16 row, so it is exact in bf16
        rows = torch.matmul(onehot, a_hi).float() + torch.matmul(onehot, a_lo).float()
        return rows.reshape(b, p, k, h1)

    def forward(self, feats0: torch.Tensor, feats1: torch.Tensor) -> torch.Tensor:
        """feats0 (template), feats1 (source): (B, P, 3+C) -> (B, P, 3+F)."""
        if self.batch_norm:
            return self._naive(feats0, feats1)
        pd = self.point_dim
        xyz0, f0 = feats0[..., :pd], feats0[..., pd:]
        xyz1, f1 = feats1[..., :pd], feats1[..., pd:]

        dense0 = self.mlp.dense(0)
        w1 = dense0.weight.t()  # (in, out), float32
        wd = w1[:pd]
        if self.append_features:
            w0, wf = w1[pd:pd + f0.shape[-1]], w1[pd + f0.shape[-1]:]
        else:
            w0, wf = -w1[pd:], w1[pd:]
        a = torch.matmul(xyz1, wd) + torch.matmul(f1, wf) + dense0.bias
        bp = torch.matmul(f0, w0) - torch.matmul(xyz0, wd)
        if self.k == 0:
            h = torch.relu(a[:, None, :, :] + bp[:, :, None, :])  # (B, P, P1, H1)
            beyond = _norm(xyz1[:, None, :, :] - xyz0[:, :, None, :]) >= self.radius
        else:
            idx, nbr_d2 = ops.knn(xyz0.detach(), xyz1.detach(), self.k)
            h = torch.relu(self._gather_rows(a, idx) + bp[:, :, None, :])  # (B, P, k, H1)
            beyond = (nbr_d2 >= self.radius * self.radius)[..., None]

        cd = self.compute_dtype
        h = h.to(cd)
        for i in range(1, len(self.mlp)):
            h = torch.relu(self.mlp.dense(i)(h, cd))
        if self.radius > 0.0:
            count("merge.cut", beyond, total="merge.pairs")
            h = torch.where(beyond, torch.zeros_like(h), h)
        feat = torch.amax(h, dim=-2).float()
        return torch.cat([xyz0, feat], dim=-1)

    def _naive(self, feats0: torch.Tensor, feats1: torch.Tensor) -> torch.Tensor:
        """The literal pair features through the MLP (the batch-norm path)."""
        pd = self.point_dim
        xyz0, f0 = feats0[..., :pd], feats0[..., pd:]
        if self.k == 0:
            grouped1 = feats1[:, None, :, :].expand(-1, feats0.shape[1], -1, -1)
        else:
            idx, _ = ops.knn(xyz0.detach(), feats1[..., :pd].detach(), self.k)
            grouped1 = ops.group_points(feats1, idx)  # (B, P, k, 3+C)
        pos_diff = grouped1[..., :pd] - xyz0[:, :, None, :]
        if self.append_features:
            f0_b = f0[:, :, None, :].expand(*pos_diff.shape[:3], -1)
            merged = torch.cat([pos_diff, f0_b, grouped1[..., pd:]], dim=-1)
        else:
            merged = torch.cat([pos_diff, grouped1[..., pd:] - f0[:, :, None, :]], dim=-1)
        h = self.mlp(merged)
        if self.radius > 0.0:
            beyond = _norm(pos_diff.detach()) >= self.radius
            count("merge.cut", beyond, total="merge.pairs")
            h = torch.where(beyond, torch.zeros_like(h), h)
        feat = torch.amax(h, dim=-2).float()
        return torch.cat([xyz0, feat], dim=-1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, keeping it; summed left to right."""
    return torch.sqrt(_sqnorm(v))[..., None]


class OutputSimple(nn.Module):
    """Mini-PointNet + FC pose head.  ``linear[0]`` is the input width
    (== mlp[-1]), not a layer.  Label-specific activations keep the rotation
    bounded: for dual quaternions sigmoid on the real scalar part and tanh
    on the real vector part; the pose Dense runs in float32.

    ``dropout_keep`` < 1 is the reference's dropout (``layers.py`` MLP with
    ``dropout_last=True``): in training mode, inverted dropout after the
    ReLU of every ``linear`` layer, the last one included; an element is
    kept with probability ``dropout_keep`` and scaled by 1/``dropout_keep``.
    With ``batch_norm`` every layer of ``conv`` and ``linear`` is Dense ->
    BatchNorm -> ReLU (then dropout).
    The masks come from the head's own ``torch.Generator`` on its device,
    never from the global generator.  ``seed_dropout(step)`` seeds it from
    (``dropout_seed``, step), as the reference folds the step into its key,
    so a run resumed at a step draws the masks an uninterrupted run draws
    there; the train step calls it before every forward.  Eval mode drops
    nothing.  ``process_group`` is None by default; data-parallel training
    sets it (``parallel.set_process_group``).  Under a group of W ranks each
    rank then draws the masks of the global batch, W × B rows, and applies
    rows [r·B, (r+1)·B) of them: JAX's process-major layout of the global
    batch, where rank r's rows follow rank r − 1's.  The loader deals
    sample i to rank i mod W, so these masks are those of a one-process
    run fed the ranks' batches side by side, not those of a plain run of
    the global batch in the dataset's order."""

    def __init__(self, in_dim: int, mlp: Sequence[int], linear: Sequence[int],
                 label_type: LabelType, batch_norm: bool = False, dropout_keep: float = 1.0,
                 compute_dtype=torch.float32, dropout_seed: int = 0):
        super().__init__()
        self.label_type = label_type
        self.dropout_keep = float(dropout_keep)
        self.dropout_seed = int(dropout_seed)
        self._dropout_gen: Optional[torch.Generator] = None
        self.process_group = None
        self.conv = MLP(in_dim, mlp, compute_dtype, batch_norm=batch_norm)
        self.linear = MLP(linear[0], linear[1:], compute_dtype, batch_norm=batch_norm)
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
        world = 1 if self.process_group is None else dist.get_world_size(self.process_group)
        if world > 1:
            # data parallel: draw at the global batch's shape and keep this
            # rank's rows in JAX's process-major layout, [r·B, (r+1)·B)
            b, r = h.shape[0], dist.get_rank(self.process_group)
            u = torch.rand((world * b,) + tuple(h.shape[1:]), generator=self._dropout_gen,
                           device=h.device)[r * b:(r + 1) * b]
        else:
            u = torch.rand(h.shape, generator=self._dropout_gen, device=h.device)
        keep = u < self.dropout_keep
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
    * ``forward``: encode template and source (as one stacked 2B batch when
      they are padded alike) and register; returns ``(y_pred, loss)``, the loss from ``loss_module``
      when the model has one and labels ``y`` are given, else None.

    Spans (``utils.profiling.span``): ``model.encode`` around each encode,
    ``model.merge`` and ``model.head`` around the motion embedding and the
    pose head of each register.
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
        with span("model.encode"):
            if aug is not None:
                pd = self.point_dim
                xyz = se3.transform_points(aug, points[..., :pd])
                points = torch.cat([xyz, points[..., pd:]], dim=-1)
            return self.cloud_features(points, mask)

    def register(self, feats0: torch.Tensor, feats1: torch.Tensor) -> torch.Tensor:
        """Encoded template/source (B, P, 3+C) -> predicted label (B, dim)."""
        with span("model.merge"):
            merged = self.merge(feats0, feats1)
        with span("model.head"):
            return self.output(merged)

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
        """Pairwise registration -> (y_pred (B, dim), loss or None).  Clouds
        padded to one shape are encoded as one stacked 2B batch (every encode
        op is per cloud, so this halves the kernel launches and changes no
        value); clouds padded differently are encoded one after the other."""
        b = template.shape[0]
        if template.shape != source.shape:
            feats0 = self.encode(template, template_mask, aug_template)
            feats1 = self.encode(source, source_mask, aug_source)
            return self._finish(self.register(feats0, feats1), y)
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
        return self._finish(self.register(feats[:b], feats[b:]), y)

    def _finish(self, y_pred: torch.Tensor, y: Optional[torch.Tensor]):
        loss = None
        if self.loss_module is not None and y is not None:
            loss = self.loss_module(y_pred, y)
        return y_pred, loss
