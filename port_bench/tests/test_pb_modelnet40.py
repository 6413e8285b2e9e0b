"""The ModelNet40 cell's inputs (``clouds/cad.py``, ``traffic/cad_train.json``):
fixed shapes whatever the run's seed, the recipe's motion within its
bounds, labels that map each source onto its template, clouds of the
converter's size, and, cut to the CPU, a run that is correct while its
control is not."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from deepclr_tpu_torch.geometry import se3
from port_bench import traffic
from port_bench.clouds import cad as CAD
from port_bench.harness import run_cell
from port_bench.yardstick import synthetic

from .conftest import BENCH, SEED


def _mix(**changes):
    tr = json.loads((BENCH / "traffic" / "cad_train.json").read_text())
    tr.update(changes)
    return tr


def _small(**changes):
    """Few shapes and pairs, each shape at 256 points from 1000."""
    return _mix(**{"shapes": 4, "pairs_per_batch": 4, "batches": 2, "surface_points": 1000, "points": 256,
                   **changes})


def _runs(tr, seed):
    return CAD.runs(tr, traffic.rng_for(seed, traffic.DATA_STREAM))


def _euler(m):
    """(roll, pitch, yaw) of ``synthetic.euler_to_matrix``'s rotation."""
    r = m[:3, :3]
    return np.array([np.arctan2(r[2, 1], r[2, 2]), -np.arcsin(r[2, 0]), np.arctan2(r[1, 0], r[0, 0])])


def test_the_shapes_do_not_depend_on_the_run_seed():
    tr = _small()
    a, b = _runs(tr, SEED), _runs(tr, SEED + 1)
    assert len(a) == len(b) == tr["pairs_per_batch"] * tr["batches"]
    for (pose_a, shape_a), (pose_b, shape_b) in ((ra[0], rb[0]) for ra, rb in zip(a, b)):
        assert np.array_equal(pose_a, np.eye(4)) and np.array_equal(pose_b, np.eye(4))
        assert np.array_equal(shape_a, shape_b)
    assert all(not np.array_equal(ra[1][1], rb[1][1]) for ra, rb in zip(a, b))   # other motions
    # run i is shape i mod shapes, and the shapes differ from one another
    assert all(np.array_equal(a[i][0][1], a[i + tr["shapes"]][0][1]) for i in range(tr["shapes"]))
    assert len({a[i][0][1].tobytes() for i in range(tr["shapes"])}) == tr["shapes"]


def test_the_motions_lie_within_the_recipes_bounds():
    tr = _mix()
    rng = traffic.rng_for(SEED, traffic.DATA_STREAM)
    motions = [CAD.motion(tr, rng) for _ in range(2000)]
    shifts = np.array([m[:3, 3] for m in motions])
    angles = np.rad2deg(np.array([_euler(m) for m in motions]))
    assert np.all(np.abs(shifts) <= 0.1) and np.all(np.abs(shifts).max(0) > 0.099)
    assert np.all(np.abs(angles) <= 5.0 + 1e-9) and np.all(np.abs(angles).max(0) > 4.99)
    for m, a in zip(motions[:5], np.deg2rad(angles[:5])):
        assert np.allclose(m[:3, :3], synthetic.euler_to_matrix(*a))


def test_labels_map_each_source_onto_its_template():
    """Without the point noise: template = M source, M the label's motion."""
    tr = _small(augment=None)
    batches = traffic.make(tr, SEED, CAD, batches=True)
    labels = []
    for batch in batches:
        assert np.allclose(batch["aug_source"], np.eye(4)) and np.allclose(batch["aug_template"], np.eye(4))
        for t, s, y in zip(batch["template"], batch["source"], batch["y"]):
            m = se3.dualquat_to_matrix(torch.from_numpy(y).double()).numpy()
            assert np.abs(s @ m[:3, :3].T + m[:3, 3] - t).max() < 1e-5
            labels.append(y)
    assert len({y.tobytes() for y in labels}) == len(labels)


def test_each_batch_holds_every_shape_once():
    tr = _small(augment=None)
    shapes = [run[0][1] for run in _runs(tr, SEED)[:tr["shapes"]]]
    for batch in traffic.make(tr, SEED, CAD, batches=True):
        assert [t.tobytes() for t in batch["template"]] == [s.tobytes() for s in shapes]


def test_the_clouds_are_the_converters_size():
    """2048 x 3 float32, picked by FPS from the model's 10000 surface points."""
    tr = _mix(pairs_per_batch=2, batches=1)
    runs = _runs(tr, SEED)
    for run in runs:
        for _, cloud in run:
            assert cloud.shape == (2048, 3) and cloud.dtype == np.float32
    surface = CAD.cad.cad_cloud(traffic.rng_for(0, traffic.WORLD_STREAM), 10000)[:, :3]
    rows = {tuple(p) for p in surface}
    assert all(tuple(p) in rows for p in runs[0][0][1])
    assert np.array_equal(runs[0][0][1][0], surface[0])   # FPS starts at the first point


def test_the_cpu_cut_cell_is_correct_and_its_control_is_not(cpu_spec):
    result = run_cell(cpu_spec, "modelnet40.train", SEED, 0.3, False, torch.device("cpu"), 0.0, ("control",))
    limits = cpu_spec.limits("modelnet40.train")
    assert result["correct"], result["check"]
    control = result["readings"]["control"]
    assert any(control[k] > limits[k] for k in limits), (control, limits)


@pytest.mark.parametrize("frames", [1, 3])
def test_a_run_is_one_pair(frames):
    with pytest.raises(ValueError):
        _runs(_small(frames=frames), SEED)
