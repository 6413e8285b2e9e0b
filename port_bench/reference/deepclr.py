"""Plain float32 DeepCLR: the benchmark's reference for what the program
computes (arXiv:2007.11255: PointNet++ multi-scale set abstraction, the
motion embedding over k nearest neighbours, the mini-PointNet pose head,
the trans + rot loss of the training recipe, and its Ranger update).

Plain PyTorch with TF32 off; it imports nothing of the program.  Weights
come as a dict keyed by the program's state-dict names (``param_spec``),
made by the benchmark from the seed, and inputs are the same raw arrays the
program is handed.  What the program derives from them the reference works
out again with the same rules (``ops``): the Morton order of a cloud of
4096 points or more before sampling (the first centre is the first point in
that order), furthest point sampling, the full radius ball, and kNN on the
expanded distance form.

Departures from the published network that the program also makes, and
which the reference follows: the ball is the full radius ball (no
``nsample`` cap); a neighbour of the motion embedding at or beyond the
radius contributes 0 to the max.

``lowp`` is the control's precision: where the program computes in its
compute dtype (bfloat16), the reference computes in float8 e4m3 with a
per-tensor scale: the inputs, the weights and the outputs of those layers
are rounded to it (straight through for the gradient), the products summed
in float32; layer 1 of each ball MLP and of the embedding and the pose
layer stay float32, as they are in the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import ops

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def strict_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, gradient straight through."""
    scale = torch.clamp_min(x.detach().abs().amax(), 1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


# ---- parameters ---------------------------------------------------------------------------------

def _dims(model_cfg) -> Dict[str, object]:
    p = model_cfg["params"]
    sa = p["cloud_features"]["params"]
    me = p["merge"]["params"]
    out = p["output"]["params"]
    return {"sa": sa, "me": me, "out": out, "input_dim": int(model_cfg["input_dim"])}


def _sa_out(sa, stage: int) -> int:
    return sum(m[-1] for m in sa["mlps"][stage])


def param_spec(model_cfg) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter, in the program's state-dict
    names (those of the reference DeepCLR).  init: "he" (ball MLPs),
    "xavier" (the other weights), "bias", "label_bias" (the pose layer)."""
    d = _dims(model_cfg)
    sa, me, out = d["sa"], d["me"], d["out"]
    spec: List[Tuple[str, Tuple[int, ...], str]] = []

    def dense(prefix, fan_in, fan_out, init, bias="bias"):
        spec.append((f"{prefix}.weight", (fan_out, fan_in), init))
        spec.append((f"{prefix}.bias", (fan_out,), bias))

    cin = d["input_dim"] - 3
    for stage in range(len(sa["npoint"])):
        for s, widths in enumerate(sa["mlps"][stage]):
            dims = [3 + cin] + list(widths)
            for i in range(len(widths)):
                dense(f"_cloud_layers.0._sa{stage}.mlps.{s}.layer{i}.conv", dims[i], dims[i + 1], "he")
        cin = _sa_out(sa, stage)
    dims = [3 + 2 * cin] + list(me["mlp"])
    for i in range(len(me["mlp"])):
        dense(f"_merge_layers.0._embedding._conv._sequential.{i}._sequential.0", dims[i], dims[i + 1], "xavier")
    dims = [3 + me["mlp"][-1]] + list(out["mlp"])
    for i in range(len(out["mlp"])):
        dense(f"_merge_layers.1.conv._sequential.{i}._sequential.0", dims[i], dims[i + 1], "xavier")
    lin = list(out["linear"])
    for i in range(len(lin) - 1):
        dense(f"_merge_layers.1.linear._sequential.{i}._sequential.0", lin[i], lin[i + 1], "xavier")
    dense("_merge_layers.1.output", lin[-1], 8, "xavier", "label_bias")
    return spec


# ---- layers -------------------------------------------------------------------------------------

def _dense(params, prefix: str, x: torch.Tensor, rnd=_identity) -> torch.Tensor:
    return rnd(torch.matmul(rnd(x), rnd(params[f"{prefix}.weight"]).t()) + params[f"{prefix}.bias"])


def _mlp(params, prefixes: Sequence[str], x: torch.Tensor, rounds: Sequence) -> torch.Tensor:
    for prefix, rnd in zip(prefixes, rounds):
        x = torch.relu(_dense(params, prefix, x, rnd))
    return x


def _ball_scale(params, prefixes, xyz, feats, valid, centres, radius: float, rnd) -> torch.Tensor:
    """One scale of one cloud: max over the radius ball of the scale's MLP
    on [x_j - c_p | f_j]; 0 for an empty ball.  xyz (N, 3), feats (N, C) or
    None, valid (N,), centres (P, 3) -> (P, H)."""
    r2 = torch.tensor(radius, dtype=torch.float32, device=xyz.device) ** 2
    d2 = ops.sq_dist(xyz[None, :, :], centres[:, None, :])          # (P, N)
    pi, ji = torch.nonzero((d2 < r2) & valid[None, :], as_tuple=True)
    x = xyz[ji] - centres[pi]
    if feats is not None:
        x = torch.cat([x, feats[ji]], dim=-1)
    h = _mlp(params, prefixes, x, [_identity] + [rnd] * (len(prefixes) - 1))
    out = torch.zeros((centres.shape[0], h.shape[-1]), dtype=h.dtype, device=h.device)
    return out.scatter_reduce(0, pi[:, None].expand(-1, h.shape[-1]), h, reduce="amax", include_self=True)


def encode(params, model_cfg, points: torch.Tensor, mask: Optional[torch.Tensor] = None,
           aug: Optional[torch.Tensor] = None, lowp: bool = False) -> torch.Tensor:
    """points (B, N, D) -> (B, P, 3 + F) features."""
    d = _dims(model_cfg)
    sa = d["sa"]
    rnd = fp8_round if lowp else _identity
    xyz = points[..., :3]
    feats = points[..., 3:] if points.shape[-1] > 3 else None
    if aug is not None:
        xyz = torch.matmul(xyz, aug[..., :3, :3].transpose(-1, -2)) + aug[..., None, :3, 3]
    if mask is None:
        mask = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
    for stage in range(len(sa["npoint"])):
        if xyz.shape[1] >= ops.SORT_MIN_POINTS:
            xyz, feats, mask = ops.morton_sort(xyz, feats, mask)
        idx = ops.fps(xyz, int(sa["npoint"][stage]), mask)
        centres = torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3))
        out = []
        for b in range(xyz.shape[0]):
            scales = []
            for s, (radius, widths) in enumerate(zip(sa["radii"][stage], sa["mlps"][stage])):
                prefixes = [f"_cloud_layers.0._sa{stage}.mlps.{s}.layer{i}.conv" for i in range(len(widths))]
                scales.append(_ball_scale(params, prefixes, xyz[b], None if feats is None else feats[b],
                                          mask[b], centres[b], float(radius), rnd))
            out.append(torch.cat(scales, dim=-1))
        xyz, feats = centres, torch.stack(out)
        mask = torch.ones(xyz.shape[:2], dtype=torch.bool, device=xyz.device)
    return torch.cat([xyz, feats], dim=-1)


def register(params, model_cfg, feats0: torch.Tensor, feats1: torch.Tensor, lowp: bool = False) -> torch.Tensor:
    """Encoded template / source (B, P, 3 + C) -> the pose label (B, 8)."""
    d = _dims(model_cfg)
    me, out = d["me"], d["out"]
    rnd = fp8_round if lowp else _identity
    xyz0, f0 = feats0[..., :3], feats0[..., 3:]
    xyz1 = feats1[..., :3]
    k = int(me["k"])
    d2 = ops.pairwise_sqdist(xyz0.detach(), xyz1.detach())
    nbr_d2, idx = torch.sort(d2, dim=-1, stable=True)
    idx, nbr_d2 = idx[..., :k], nbr_d2[..., :k]                    # (B, P, k)
    g1 = torch.gather(feats1[:, None, :, :].expand(-1, idx.shape[1], -1, -1), 2,
                      idx[..., None].expand(-1, -1, -1, feats1.shape[-1]))
    pair = torch.cat([g1[..., :3] - xyz0[:, :, None, :],
                      f0[:, :, None, :].expand(-1, -1, k, -1), g1[..., 3:]], dim=-1)
    n_me = len(me["mlp"])
    h = _mlp(params, [f"_merge_layers.0._embedding._conv._sequential.{i}._sequential.0" for i in range(n_me)],
             pair, [_identity] + [rnd] * (n_me - 1))
    radius = float(me["radius"])
    if radius > 0.0:
        h = torch.where((nbr_d2 >= radius * radius)[..., None], torch.zeros_like(h), h)
    x = torch.cat([xyz0, torch.amax(h, dim=-2)], dim=-1)
    n_conv = len(out["mlp"])
    h = _mlp(params, [f"_merge_layers.1.conv._sequential.{i}._sequential.0" for i in range(n_conv)],
             x, [rnd] * n_conv)
    h = torch.amax(h, dim=-2)
    n_lin = len(out["linear"]) - 1
    h = _mlp(params, [f"_merge_layers.1.linear._sequential.{i}._sequential.0" for i in range(n_lin)],
             h, [rnd] * n_lin)
    y = _dense(params, "_merge_layers.1.output", h)
    return torch.cat([torch.sigmoid(y[:, 0:1]), torch.tanh(y[:, 1:4]), y[:, 4:]], dim=1)


def forward(params, model_cfg, template, source, template_mask=None, source_mask=None,
            aug_template=None, aug_source=None, lowp: bool = False) -> torch.Tensor:
    """Pairwise registration (B, 8); both clouds of a pair go through one
    stacked encode of 2B clouds, as the program encodes them."""
    b = template.shape[0]
    both = torch.cat([template, source])
    mask = None
    if template_mask is not None:
        mask = torch.cat([template_mask, source_mask])
    aug = None
    if aug_template is not None:
        aug = torch.cat([aug_template, aug_source])
    feats = encode(params, model_cfg, both, mask, aug, lowp)
    return register(params, model_cfg, feats[:b], feats[b:], lowp)


def forward_batch(params, model_cfg, batch, lowp: bool = False) -> torch.Tensor:
    """``forward`` of a training batch dict (the loader's keys)."""
    return forward(params, model_cfg, *(batch[key] for key in (
        "template", "source", "template_mask", "source_mask", "aug_template", "aug_source")), lowp=lowp)


# ---- the training recipe ------------------------------------------------------------------------

def _normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x[:, :4], dim=1, keepdim=True) + eps)


def _pnorm2(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=1) + 1e-20)


def loss(y_pred: torch.Tensor, y: torch.Tensor, loss_cfg) -> torch.Tensor:
    """The recipe's loss: the weighted batch means of the translation
    (dual part) and rotation (real part) distances of the normalised dual
    quaternions (p = 2)."""
    s, t = _normalize(y_pred), _normalize(y)
    total = 0.0
    for term in loss_cfg:
        if term["type"] == "trans":
            v = _pnorm2(s[:, 4:] - t[:, 4:])
        elif term["type"] == "rot":
            v = _pnorm2(s[:, :4] - t[:, :4])
        else:
            raise ValueError(f"reference: no loss term {term['type']!r}")
        if int((term.get("params") or {}).get("p", 2)) != 2:
            raise ValueError("reference: only p = 2")
        total = total + float(term["weights"][0]) * v.mean()
    return total


# Ranger as the recipe runs it without overrides: gradient centralisation
# -> RAdam (eps added to the root of the bias-corrected second moment,
# rectified once rho reaches the threshold) -> decoupled weight decay on
# tensors of rank >= 2 -> x(-lr) -> Lookahead (sync every 6 updates, slow step 0.5)
RANGER_B1 = 0.95
RANGER_B2 = 0.999
RANGER_EPS = 1e-5
RANGER_SYNC = 6
RANGER_SLOW = 0.5
RANGER_THRESHOLD = 5.0


def centralise(g: torch.Tensor) -> torch.Tensor:
    if g.dim() >= 2:
        return g - g.mean(dim=tuple(range(1, g.dim())), keepdim=True)
    return g


def rectifier(count: int) -> Optional[float]:
    """RAdam's r_t, or None while rho_t is below the threshold (the update
    is then the first moment alone)."""
    b2, rho_inf = RANGER_B2, 2.0 / (1.0 - RANGER_B2) - 1.0
    b2t = b2 ** count
    rho = rho_inf - 2.0 * count * b2t / (1.0 - b2t)
    if rho < RANGER_THRESHOLD:
        return None
    return math.sqrt((rho - 4.0) * (rho - 2.0) * rho_inf / ((rho_inf - 4.0) * (rho_inf - 2.0) * rho))


def ranger(param: torch.Tensor, grad: torch.Tensor, state: Dict, lr: float, wd: float) -> torch.Tensor:
    """One Ranger update of one leaf from ``state`` (``count``, ``mu``,
    ``nu``, ``slow``, ``la_count``; empty before the first update) with
    its centralised gradient: the leaf after it."""
    count = int(state.get("count", 0)) + 1
    mu = (1.0 - RANGER_B1) * grad + RANGER_B1 * state.get("mu", torch.zeros_like(param))
    nu = (1.0 - RANGER_B2) * grad * grad + RANGER_B2 * state.get("nu", torch.zeros_like(param))
    mu_hat = mu / (1.0 - RANGER_B1 ** count)
    nu_hat = nu / (1.0 - RANGER_B2 ** count)
    r = rectifier(count)
    u = mu_hat if r is None else r * mu_hat / (torch.sqrt(nu_hat) + RANGER_EPS)
    if wd and param.dim() >= 2:
        u = u + wd * param
    fast = param - lr * u
    if (int(state.get("la_count", 0)) + 1) % RANGER_SYNC:
        return fast
    slow = state.get("slow", param)
    return slow + RANGER_SLOW * (fast - slow)


def first_update(params: Dict[str, torch.Tensor], model_cfg, train_cfg, batches, lr: float,
                 lowp: bool = False, loss_rows: Optional[int] = None):
    """The recipe's first update (accumulation 2) from ``params``: the
    losses and poses of its two micro-steps, each leaf's centralised
    gradient, and the parameters after it.
    ``loss_rows`` is a fault for the calibration: the forward over the
    whole batch, the loss's mean over its first rows only."""
    k = int(train_cfg["optimizer"].get("accumulation_steps", 1))
    if k != 2 or len(batches) != k:
        raise ValueError("reference: the recipe's accumulation is 2")
    wd = float(train_cfg["optimizer"].get("weight_decay", 0.0))
    loss_cfg = train_cfg["metrics"]["loss"]
    names = list(params)
    losses, ys, grad = [], [], {n: torch.zeros_like(params[n]) for n in names}
    for batch in batches:
        with torch.enable_grad():
            live = {n: params[n].detach().requires_grad_(True) for n in names}
            y = forward_batch(live, model_cfg, batch, lowp)
            rows = slice(None) if loss_rows is None else slice(0, loss_rows)
            value = loss(y[rows], batch["y"][rows], loss_cfg)
            grads = torch.autograd.grad(value / k, [live[n] for n in names], allow_unused=True)
        for n, g in zip(names, grads):
            if g is not None:
                grad[n] = grad[n] + g
        losses.append(value.detach())
        ys.append(y.detach())
    grad = {n: centralise(g) for n, g in grad.items()}
    after = {n: ranger(params[n], grad[n], {}, lr, wd) for n in names}
    return losses, ys, grad, after


def train_steps(params0: Dict[str, torch.Tensor], model_cfg, train_cfg, batches, lr: float,
                lowp: bool = False, loss_rows: Optional[int] = None):
    """The first three micro-steps of the recipe from the seed's weights, on
    the first three batches: losses of steps 1-3, the first update's
    centralised gradient per leaf, the parameters' change after step 3 (the
    first update) per leaf, and the poses of steps 1-3."""
    losses, ys, grad, params1 = first_update(params0, model_cfg, train_cfg, batches[:2], lr, lowp, loss_rows)
    y = forward_batch(params1, model_cfg, batches[2], lowp)
    rows = slice(None) if loss_rows is None else slice(0, loss_rows)
    losses.append(loss(y[rows], batches[2]["y"][rows], train_cfg["metrics"]["loss"]).detach())
    ys.append(y.detach())
    change = {n: params1[n] - params0[n] for n in params0}
    return losses, grad, change, ys
