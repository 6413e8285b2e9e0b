"""What decides ``correct``: the numbers that compare what the timed path
produced with the plain reference (``reference/deepclr.py``), each held to
its limit in ``limits/<workload>.json``; a number the cell's limits do not
name is read (the calibration prints it) but not held to anything.

Training cells.  The first three micro-steps of the window's own step, on
three different batches, from the seed's weights, against the reference's
own three steps:

* ``loss``: the worst step's |program - reference| / |reference| loss;
* ``grad``: the first update's gradient as the optimizer got it (its first
  moment over 1 - b1), by the worst leaf: |norm program - norm reference|
  over the larger of the leaf's and the median leaf's reference norm;
* ``update``: the same for the parameters' change after step 3, over the
  leaves whose reference gradient is at least 1e-3 of the median leaf's;
* ``pose``: the poses of steps 1 and 2 (the loss's input, before the
  update), as below.

Then two stages judged on the program's own outputs, over the first three
micro-steps and the updates the window's own call takes after the window
from the state the window left (the next one, and the next Lookahead sync):

* ``loss_of_poses``: the worst micro-step's |program loss - reference loss
  of the program's poses and the batch's labels| / the latter;
* ``window_update``: the reference's Ranger update from a snapshot of the
  parameters and the optimizer's state, with the gradient the optimizer
  got (from its first moment), against the program's: by the worst leaf,
  the norm of their difference over the larger of the leaf's and the
  median leaf's reference change.

Inference cells: ``pose``, over a sample drawn from the seed of the
window's answers, the widest |program - reference| of a pose component over
the largest reference component in the sample.  The reference
replays the helper's generator to pad each cloud as the helper did.

``extras`` asks for the calibration's readings beside the program's: the
control (the reference at float8 in the program's place: the first three
steps and the poses) and, for training, the fault ``half_batch``: the
forward over the whole batch, the loss's mean over its first half only
(the first three steps and ``loss_of_poses``).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import traffic
from .reference import deepclr as ref

NEGLIGIBLE_GRAD = 1e-3   # of the median leaf's reference gradient: left out of ``update``
POSE_SAMPLE = 24         # answers of an inference window compared
REF_BLOCK = 8            # pairs a reference forward


def norms(tensors) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def leaf_gap(prog: Dict[str, float], want: Dict[str, float], names: Sequence[str]) -> float:
    if not all(math.isfinite(prog[n]) for n in names):
        return math.inf
    med = statistics.median(want[n] for n in want)
    return max(abs(prog[n] - want[n]) / max(want[n], med, 1e-30) for n in names)


def loss_gap(prog: Sequence[float], want: Sequence[float]) -> float:
    if not all(math.isfinite(v) for v in prog):
        return math.inf
    return max(abs(p - w) / abs(w) for p, w in zip(prog, want))


def moved(grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(grad.values())
    return [n for n in grad if grad[n] >= NEGLIGIBLE_GRAD * med]


def first_gaps(prog, want) -> Dict[str, float]:
    """``prog`` and ``want``: (losses, gradient norms, change norms, poses) of the first three steps."""
    losses, grad, change, poses = want
    return {"loss": loss_gap(prog[0], losses), "grad": leaf_gap(prog[1], grad, list(grad)),
            "update": leaf_gap(prog[2], change, moved(grad)),
            "pose": pose_gap(np.concatenate(prog[3][:2]), np.concatenate(poses[:2]))}


def first_reference(entry, batches, **kwargs):
    ref.strict_float32()
    losses, grad, change, poses = ref.train_steps(entry.weights, entry.model_cfg, entry.cell.config["train"],
                                                  batches[:3], entry.lr, **kwargs)
    return [float(v) for v in losses], norms(grad), norms(change), [y.double().cpu().numpy() for y in poses]


def loss_of_poses(entry, batches, loss_rows: Optional[int] = None) -> float:
    """The program's losses against the reference's loss of the program's
    own poses, over every micro-step the check saw; ``loss_rows`` puts the
    reference's fault in the program's place."""
    cfg = entry.cell.config["train"]["metrics"]["loss"]
    seen = [(entry.first_losses, entry.first_poses, [0, 1, 2])]
    seen += [(u["losses"], u["poses"], u["rows"]) for u in entry.window_updates]
    worst = 0.0
    for losses, poses, rows in seen:
        for value, y, r in zip(losses, poses, rows):
            label = batches[r]["y"].double().cpu()
            y = torch.from_numpy(y)
            if y.shape != label.shape:   # the program's loss saw other rows than the batch's
                return math.inf
            want = float(ref.loss(y, label, cfg))
            if loss_rows is not None:
                value = float(ref.loss(y[:loss_rows], label[:loss_rows], cfg))
            worst = max(worst, abs(value - want) / abs(want) if math.isfinite(value) else math.inf)
    return worst


def window_update(entry) -> float:
    """The program's updates after the window against the reference's
    Ranger from the same snapshot and gradient."""
    wd = float(entry.cell.config["train"]["optimizer"].get("weight_decay", 0.0))
    worst = 0.0
    for u in entry.window_updates:
        snap = u["snapshot"]
        gaps, want = {}, {}
        for n, s in snap.items():
            state = {k: (v.double() if torch.is_tensor(v) else v) for k, v in s.items()}
            # the parameter after it, in its own dtype, as the program keeps it
            after = ref.ranger(state["param"], u["grad"][n].double(), state, entry.lr, wd).to(s["param"].dtype)
            change = after.double() - state["param"]
            want[n] = float(torch.linalg.vector_norm(change))
            gaps[n] = float(torch.linalg.vector_norm(u["change"][n].double() - change))
        med = statistics.median(want.values())
        worst = max([worst] + [gaps[n] / max(want[n], med, 1e-30) for n in gaps])
    return worst


def train_numbers(entry, batches, extras: Sequence[str] = ()) -> Dict[str, Dict[str, float]]:
    want = first_reference(entry, batches)
    prog = (entry.first_losses, entry.first_grad, entry.first_change, entry.first_poses)
    out = {"program": {**first_gaps(prog, want), "loss_of_poses": loss_of_poses(entry, batches),
                       "window_update": window_update(entry)}}
    if "control" in extras:
        out["control"] = first_gaps(first_reference(entry, batches, lowp=True), want)
    if "half_batch" in extras:
        rows = batches[0]["y"].shape[0] // 2
        out["half_batch"] = {**first_gaps(first_reference(entry, batches, loss_rows=rows), want),
                             "loss_of_poses": loss_of_poses(entry, batches, loss_rows=rows)}
    return out


def replay_pads(entry, needed: Sequence[int]) -> Dict[int, tuple]:
    """The helper's pads of the listed draws, worked out again: its
    generator replayed from the seed the benchmark gave it, one
    ``choice(n, num_points, replace=False)`` per cloud larger than the
    buffer, in the order of the draws."""
    rng = np.random.default_rng(traffic.helper_seed(entry.cell.seed))
    want, last, out = set(needed), max(needed), {}
    dim = int(entry.model_cfg["input_dim"])
    p = entry.num_points
    for d, f in enumerate(entry.draws[:last + 1]):
        cloud = entry.frames[f][:, :dim]
        n = cloud.shape[0]
        if n > p:
            sel = rng.choice(n, size=p, replace=False)
            if d in want:
                out[d] = (cloud[sel].astype(np.float32), np.ones(p, bool))
        elif d in want:
            pts = np.zeros((p, dim), np.float32)
            pts[:n] = cloud
            mask = np.zeros(p, bool)
            mask[:n] = True
            out[d] = (pts, mask)
    return out


def pose_gap(prog: np.ndarray, want: np.ndarray) -> float:
    """The widest gap of any pose component over the largest reference
    component in the sample: the head's rounding errors are about equal in
    every component, so one scale serves all eight."""
    if prog.shape != want.shape or not np.all(np.isfinite(prog)):
        return math.inf
    return float(np.abs(prog - want).max() / max(float(np.abs(want).max()), 1e-12))


def pose_reference(entry, pads, pairs, lowp: bool = False) -> np.ndarray:
    ref.strict_float32()
    dev = entry.device
    out = []
    with torch.no_grad():
        for i in range(0, len(pairs), REF_BLOCK):
            block = pairs[i:i + REF_BLOCK]
            t = torch.from_numpy(np.stack([pads[a][0] for a, _ in block])).to(dev)
            tm = torch.from_numpy(np.stack([pads[a][1] for a, _ in block])).to(dev)
            s = torch.from_numpy(np.stack([pads[b][0] for _, b in block])).to(dev)
            sm = torch.from_numpy(np.stack([pads[b][1] for _, b in block])).to(dev)
            out.append(ref.forward(entry.weights, entry.model_cfg, t, s, tm, sm, lowp=lowp).cpu().numpy())
    return np.concatenate(out).astype(np.float64)


def pose_sample(entry, outputs) -> List[int]:
    rng = traffic.rng_for(entry.cell.seed, traffic.SAMPLE_STREAM)
    count = min(POSE_SAMPLE, len(outputs))
    return sorted(rng.choice(len(outputs), size=count, replace=False).tolist())


def pose_numbers(entry, outputs, extras: Sequence[str] = ()):
    """``outputs``: ((template draw, source draw), pose) of each answer."""
    if not outputs:
        return {"program": {"pose": math.inf}}
    picked = [outputs[i] for i in pose_sample(entry, outputs)]
    if any(p is None for _, p in picked):
        return {"program": {"pose": math.inf}}
    pairs = [d for d, _ in picked]
    pads = replay_pads(entry, [d for pair in pairs for d in pair])
    want = pose_reference(entry, pads, pairs)
    prog = np.stack([np.asarray(p, np.float64) for _, p in picked])
    out = {"program": {"pose": pose_gap(prog, want)}}
    if "control" in extras:
        out["control"] = {"pose": pose_gap(pose_reference(entry, pads, pairs, lowp=True), want)}
    return out
