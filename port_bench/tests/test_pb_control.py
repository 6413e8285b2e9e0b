"""The comparison that decides ``correct`` fails what it must, at a size
the CPU holds, with the cells' own limits: the control (the reference at
float8 in the program's place) and each fault a cell can have, planted
in the program underneath a run that skips only the look for a card."""
from __future__ import annotations

import pytest
import torch

from port_bench.harness import run_cell

from .conftest import SEED

CPU = torch.device("cpu")
CELLS = ["kitti.train", "kitti.odometry"]


def _run(spec, workload, extras=(), seconds=0.3):
    return run_cell(spec, workload, SEED, seconds, False, CPU, 0.0, extras)


@pytest.mark.parametrize("workload", CELLS)
def test_program_is_correct_and_control_is_not(cpu_spec, workload):
    result = _run(cpu_spec, workload, ("control",))
    limits = cpu_spec.limits(workload)
    assert result["correct"], result["check"]
    control = result["readings"]["control"]
    assert any(control[k] > limits[k] for k in limits), (control, limits)


def _no_update(monkeypatch):
    from deepclr_tpu_torch.solver import optimizers

    monkeypatch.setattr(optimizers.Ranger, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    """The forward over the whole batch, the loss's mean over its first half."""
    from deepclr_tpu_torch import losses

    make_loss_fn = losses.make_loss_fn

    def half(*args, **kwargs):
        loss_fn = make_loss_fn(*args, **kwargs)

        def over_half(y_pred, y):
            rows = y.shape[0] // 2
            return loss_fn(y_pred[:rows], y[:rows])

        return over_half

    monkeypatch.setattr(losses, "make_loss_fn", half)


def _no_lookahead(monkeypatch):
    """Ranger's Lookahead never syncs the slow weights.  Shows once the
    window has passed a sync (6 updates): the slow weights the window left
    are then stale."""
    from deepclr_tpu_torch import solver

    make_optimizer = solver.make_optimizer

    def never(*args, **kwargs):
        opt = make_optimizer(*args, **kwargs)
        for group in opt.param_groups:
            group["sync_period"] = 10 ** 9
        return opt

    monkeypatch.setattr(solver, "make_optimizer", never)


def _no_rectifier(monkeypatch):
    """RAdam's rectified step never switches on: the update stays the first moment."""
    from deepclr_tpu_torch.solver import optimizers

    monkeypatch.setattr(optimizers.Ranger, "_rectifier", staticmethod(lambda b2, count, threshold: None))


def _altered_answer(monkeypatch):
    from deepclr_tpu_torch.models import deepclr

    forward = deepclr.OutputSimple.forward

    def altered(self, x):
        y = forward(self, x).clone()
        y[:, 5] = y[:, 5] * 1.5 + 0.01
        return y

    monkeypatch.setattr(deepclr.OutputSimple, "forward", altered)


def _stale_state(monkeypatch):
    from deepclr_tpu_torch.models import deepclr

    encode_register = deepclr.DeepCLR.encode_register

    def stale(self, feats0, points, mask=None):
        y, _ = encode_register(self, feats0, points, mask)
        return y, feats0

    monkeypatch.setattr(deepclr.DeepCLR, "encode_register", stale)


FAULTS = [
    ("kitti.train", _no_update), ("kitti.train", _half_batch), ("kitti.train", _no_lookahead),
    ("kitti.train", _no_rectifier),
    ("kitti.odometry", _stale_state), ("kitti.odometry", _altered_answer),
]


WINDOW_S = {_no_lookahead: 4.0}   # long enough for the window to pass a sync


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f.__name__.strip('_')}" for w, f in FAULTS])
def test_fault_is_not_correct(cpu_spec, monkeypatch, workload, fault):
    fault(monkeypatch)
    result = _run(cpu_spec, workload, seconds=WINDOW_S.get(fault, 0.3))
    if fault is _no_lookahead:
        assert result["attempted"] >= 12, "the window passed no Lookahead sync"
    assert not result["correct"], result["check"]
