"""``python -m deepclr_tpu_torch.evaluation`` and ``.kitti_devkit`` on the
CPU, against ``scripts/evaluation.py`` and the JAX package's devkit.

The run directories are written as the inference and ICP CLIs write them
(``scenario.yaml`` with a ``method`` entry, one 26-column file a sequence):
two runs of a sequential scenario (a 120-frame drive, past the shortest
KITTI segment, and a 20-frame one, whose segment errors are NaN) and one
run of a pairwise scenario.  The script evaluates copies of them with
pandas and matplotlib; the port evaluates others with
``sys.modules["pandas"]`` and ``["matplotlib"]`` set to None, so neither
imports.  Every CSV must be byte-identical.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

pytest.importorskip("torch")

from deepclr_tpu_torch.evaluation import Evaluator  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SEQ_SCENARIO = "synth_seq"


def _motions(seed, n, noise):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        yaw = 0.02 * rng.normal() + noise * rng.normal()
        m = np.eye(4)
        m[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        m[:3, 3] = [1.0 + 0.1 * rng.normal(), 0.02 * rng.normal(), 0.005 * rng.normal()]
        m[:3, 3] += noise * rng.normal(size=3)
        out.append(m)
    return out


def _write_run(base, dirname, scenario, method, params, lengths, seed):
    run = base / dirname
    run.mkdir(parents=True)
    ev = Evaluator()
    for k, (name, n) in enumerate(lengths.items()):
        gt = _motions(seed + k, n, 0.0)
        pred = [g @ d for g, d in zip(gt, _motions(seed + 10 + k, n, 0.01))]
        times = np.random.default_rng(seed + 20 + k).uniform(1, 5, size=n)
        for i in range(n):
            ev.add_transforms(name, i * 1e5, pred[i], gt[i], times[i])
    ev.write(str(run))
    cfg = dict(scenario, data={name: f"/data/{name}.pack" for name in lengths},
               method={"name": method, "params": params})
    with open(run / "scenario.yaml", "w") as f:
        yaml.dump(cfg, f, default_flow_style=False, sort_keys=False)
    return run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The run directories, evaluated by scripts/evaluation.py (multi-run
    mode over the sequential scenario, single-run mode on the pairwise run);
    returns (pristine copy, the script's output)."""
    base = tmp_path_factory.mktemp("pristine")
    seq = {"name": SEQ_SCENARIO, "dataset_type": "kitti_odometry_velodyne", "sequential": True}
    icp = {"max_distance": 1.0, "neighbor_radius": 1.0, "max_nn": 30, "max_iterations": 100, "epsilon": 0.001}
    _write_run(base, f"20260101_000000_{SEQ_SCENARIO}_ICP_PO2PO", seq, "ICP_PO2PO", icp, {"00": 120, "01": 20}, 1)
    _write_run(base, f"20260101_000001_{SEQ_SCENARIO}_GICP", seq, "GICP", icp, {"00": 120, "01": 20}, 2)
    _write_run(base, "20260101_000002_synth_pairs_DEEPCLR",
               {"name": "synth_pairs", "dataset_type": "generic", "sequential": False}, "DEEPCLR",
               {"model_name": "m", "model_file": "/m/model_config.yaml", "weights_file": "/m/weights.pt"},
               {"08": 12}, 3)
    ref = tmp_path_factory.mktemp("ref")
    shutil.copytree(base, ref, dirs_exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    script = str(REPO / "scripts" / "evaluation.py")
    subprocess.run([sys.executable, script, str(ref), "--scenario", SEQ_SCENARIO], env=env, check=True,
                   capture_output=True, timeout=300)
    subprocess.run([sys.executable, script, str(ref / "20260101_000002_synth_pairs_DEEPCLR")], env=env, check=True,
                   capture_output=True, timeout=300)
    return base, ref


def _csvs(root):
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*.csv"))}


def _without_pandas_and_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "pandas", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def test_multi_and_single_run_csvs_are_byte_identical_without_pandas_or_matplotlib(runs, tmp_path, monkeypatch):
    from deepclr_tpu_torch.evaluation import cli

    base, ref = runs
    shutil.copytree(base, tmp_path, dirs_exist_ok=True)
    _without_pandas_and_matplotlib(monkeypatch)
    cli.main([str(tmp_path), "--scenario", SEQ_SCENARIO])
    cli.main([str(tmp_path / "20260101_000002_synth_pairs_DEEPCLR")])
    got, want = _csvs(tmp_path), _csvs(ref)
    assert sorted(got) == sorted(want) and len(want) == 7
    for name in want:
        assert got[name] == want[name], name
    # the short drive's segment errors are NaN: empty fields, as pandas writes them
    segment = tmp_path / f"20260101_000000_{SEQ_SCENARIO}_ICP_PO2PO" / "evaluation" / "segment_errors.csv"
    assert segment.read_text().splitlines()[2].startswith("01,,")
    assert not list(tmp_path.rglob("*.png"))


def test_single_run_mode_matches_the_script(runs, tmp_path, monkeypatch):
    """Single-run mode on each sequential run directory gives the script's
    step and segment tables; with matplotlib it also draws the figures."""
    from deepclr_tpu_torch.evaluation import cli

    base, ref = runs
    shutil.copytree(base, tmp_path, dirs_exist_ok=True)
    for run in sorted(p for p in tmp_path.iterdir() if SEQ_SCENARIO in p.name):
        cli.main([str(run)])
        for name in ("step_errors.csv", "segment_errors.csv"):
            assert (run / "evaluation" / name).read_bytes() == \
                (ref / run.name / "evaluation" / name).read_bytes(), (run.name, name)
        for sub in ("plot_eot", "plot_error", "plot_path", "plot_path2d"):
            assert sorted(p.name for p in (run / "evaluation" / sub).iterdir()) == \
                sorted(p.name for p in (ref / run.name / "evaluation" / sub).iterdir())
        assert (run / "evaluation" / "segment_errors.png").exists()


def _write_poses(path, poses):
    np.savetxt(path, np.asarray([np.asarray(p)[:3, :].reshape(12) for p in poses]))


@pytest.mark.parametrize("matplotlib", [True, False])
def test_devkit_cli_writes_the_tables_with_or_without_matplotlib(tmp_path, monkeypatch, capsys, matplotlib):
    """The tables always, byte-identical to the JAX package's devkit; the
    plots only with matplotlib, else one log line and no error."""
    from deepclr_tpu.native import kitti_devkit_eval
    from deepclr_tpu_torch.kitti_devkit.__main__ import main

    gt_dir, pred_dir = tmp_path / "gt", tmp_path / "pred"
    gt_dir.mkdir()
    pred_dir.mkdir()
    pose, pred = np.eye(4), np.eye(4)
    gts, preds = [], []
    for d in _motions(5, 150, 0.0):
        pose = pose @ d
        pred = pred @ d @ _motions(6, 1, 0.01)[0]
        gts.append(pose.copy())
        preds.append(pred.copy())
    _write_poses(gt_dir / "04.txt", gts)
    _write_poses(pred_dir / "04.txt", preds)
    if not matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert main([str(gt_dir), str(pred_dir), str(tmp_path / "port")]) == 1
    out = capsys.readouterr().out
    assert "evaluated 1 sequences" in out
    assert kitti_devkit_eval(str(gt_dir), str(pred_dir), str(tmp_path / "jax")) == 1
    tables = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert "stats.txt" in tables and "errors_04.txt" in tables
    for name in tables:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    plots = sorted(p.name for p in (tmp_path / "port").glob("*.png"))
    if matplotlib:
        assert {"04_path.png", "04_tl.png", "avg_tl.png", "avg_rs.png"} <= set(plots)
    else:
        assert plots == [] and "devkit plots are skipped" in out
