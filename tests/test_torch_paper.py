"""``python -m deepclr_tpu_torch.paper.*`` against ``scripts/paper/*.py`` on
the CPU.

The run directories are written by the port's own CLIs, in process, on
small packs laid out as the shipped scenarios expect them
(``configs/scenarios/{kitti_04_10,kitti_pairs,modelnet40_unseen}.yaml``,
cut to the packs written here): ``python -m deepclr_tpu_torch.inference``
with a narrow DeepCLR (seed-0 weights) for each scenario, and ``.icp``
(po2pl, on the CPU) for the two pairwise ones, so their tables have two
methods.  Then:

* each table's stdout equals its script's byte for byte where pandas
  imports (both print ``pandas.DataFrame(data).transpose()`` of the same
  numbers: the port's Evaluator gives the JAX package's bits);
* without pandas (``sys.modules["pandas"] = None`` in a subprocess) each
  prints the same title, rows and columns, every number its shortest repr:
  equal to the port's ``evaluate`` and, to print precision, to the pandas
  table;
* ``modelnet40_plots``' curves equal the script's ``evaluate`` within
  1e-12 and its PNG and PDF files are written under ``MPLBACKEND=Agg``;
* ``cloud_figures`` writes its two renders.
"""
import contextlib
import io
import json
import os
import os.path as osp
import re
import subprocess
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from deepclr_tpu_torch import inference  # noqa: E402
from deepclr_tpu_torch.data import PackWriter  # noqa: E402
from deepclr_tpu_torch.evaluation import load_scenario  # noqa: E402
from deepclr_tpu_torch.icp import cli as icp_cli  # noqa: E402
from deepclr_tpu_torch.models import build_model, save_weights  # noqa: E402
from deepclr_tpu_torch.paper import (_runs, cloud_figures, kitti_artificial_table,  # noqa: E402
                                     kitti_odometry_table, modelnet40_plots, modelnet40_table)

REPO = osp.realpath(osp.join(osp.dirname(__file__), ".."))
N = 256
TABLES = {"kitti_odometry_table": kitti_odometry_table, "kitti_artificial_table": kitti_artificial_table,
          "modelnet40_table": modelnet40_table}
MODEL_CFG = {  # the narrow DeepCLR of tests/test_torch_inference.py
    "input_dim": 4, "point_dim": 3, "label_type": "pose3d_dual_quat", "model_type": "deepclr",
    "params": {
        "batch_norm": False, "dropout": 1.0,
        "cloud_features": {"name": "SetAbstraction",
                           "params": {"npoint": [32], "radii": [[1.0, 2.0]], "nsamples": [[8, 16]],
                                      "mlps": [[[8, 8, 16], [8, 8, 16]]]}},
        "merge": {"name": "MotionEmbedding", "params": {"k": 4, "radius": 10.0, "mlp": [16, 32]}},
        "output": {"name": "OutputSimple", "params": {"mlp": [32, 64], "linear": [64, 32]}},
    },
}
SEQUENCES = {"04": 6, "10": 5}  # frames a KITTI sequence of kitti_04_10
PAIRS = {"08": 3, "09": 2}       # pairs a pack of kitti_pairs
MN_PAIRS = 2                     # pairs a noise level of modelnet40_unseen


def _cloud(rng, n, scale):
    cloud = rng.normal(size=(n, 4)).astype(np.float32)
    cloud[:, :3] *= scale
    return cloud


def _rigid(rng, t_scale):
    yaw = 0.05 * rng.normal()
    m = np.eye(4)
    m[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    m[:3, 3] = rng.normal(size=3) * t_scale
    return m


def _write_sequence(path, frames, seed):
    rng = np.random.default_rng(seed)
    base = _cloud(rng, 300, 5.0)
    pose = np.eye(4)
    with PackWriter(str(path)) as w:
        for i in range(frames):
            w.put(f"{i:08d}", {"idx": i, "timestamp": i * 1e5, "pose": pose.copy(),
                               "cloud": base + rng.normal(size=base.shape).astype(np.float32) * 0.01})
            pose = pose @ _rigid(rng, 0.5)


def _write_pairs(path, pairs, seed, scale, noise=0.0):
    rng = np.random.default_rng(seed)
    with PackWriter(str(path)) as w:
        for i in range(pairs):
            t = _cloud(rng, int(rng.integers(200, 300)), scale)
            m = _rigid(rng, 0.1 * scale)
            s = t.copy()
            s[:, :3] = (t[:, :3] - m[:3, 3]) @ m[:3, :3] + rng.normal(size=(len(t), 3)) * noise
            w.put(f"{i:06d}", {"idx": [i, i + 1], "timestamps": [float(i), float(i + 1)],
                               "clouds": [t, s], "transform": m})


def _scenario(ws, name, dataset_type, sequential, data):
    path = ws / f"{name}.yaml"
    with open(path, "w") as f:
        yaml.dump({"name": name, "dataset_type": dataset_type, "sequential": sequential, "data": data}, f)
    return str(path)


def _capture(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        fn(*args)
    return out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(base directory of the run directories, the workspace, the scripts'
    stdout and the ModelNet40 script's curves)."""
    ws = tmp_path_factory.mktemp("paper")
    kitti, modelnet = ws / "kitti", ws / "modelnet40"
    (kitti / "odometry").mkdir(parents=True)
    (kitti / "pairs_test").mkdir()
    (modelnet / "test").mkdir(parents=True)
    for k, (seq, frames) in enumerate(SEQUENCES.items()):
        _write_sequence(kitti / "odometry" / f"{seq}.pack", frames, seed=k)
    for k, (seq, pairs) in enumerate(PAIRS.items()):
        _write_pairs(kitti / "pairs_test" / f"{seq}.pack", pairs, seed=10 + k, scale=5.0)
    noise = {f"test_unseen_{s:0.2f}": s for s in modelnet40_plots.NOISE_LEVELS}
    for k, (name, sigma) in enumerate(noise.items()):
        _write_pairs(modelnet / "test" / f"{name}.pack", MN_PAIRS, seed=20 + k, scale=0.5, noise=sigma)
    scenarios = {
        "kitti_04_10": _scenario(ws, "kitti_04_10", "kitti_odometry_velodyne", True,
                                 {s: str(kitti / "odometry" / f"{s}.pack") for s in SEQUENCES}),
        "kitti_pairs": _scenario(ws, "kitti_pairs", "generic", False,
                                 {s: str(kitti / "pairs_test" / f"{s}.pack") for s in PAIRS}),
        "modelnet40_unseen": _scenario(ws, "modelnet40_unseen", "generic", False,
                                       {n: str(modelnet / "test" / f"{n}.pack") for n in noise}),
    }
    (ws / "models" / "toy").mkdir(parents=True)
    with open(ws / "models" / "toy" / "model_config.yaml", "w") as f:
        yaml.dump(MODEL_CFG, f)
    save_weights(str(ws / "models" / "toy" / "weights.pt"), build_model(MODEL_CFG, device="cpu", seed=0))

    out = ws / "out"
    for path in scenarios.values():
        inference.main([path, "toy", str(out), "--model_path", str(ws / "models"), "--num_points", str(N),
                        "--device", "cpu"])
    for name in ("kitti_pairs", "modelnet40_unseen"):
        icp_cli.run(load_scenario(scenarios[name]), "icp_po2pl", str(out), max_iterations=10, device="cpu")
    assert len(os.listdir(out)) == 5

    code = (
        "import contextlib, io, json, runpy, sys\n"
        f"paper = {osp.join(REPO, 'scripts', 'paper')!r}\n"
        "out = {}\n"
        f"for name in {sorted(TABLES)!r}:\n"
        f"    sys.argv = [name + '.py', {str(out)!r}]\n"
        "    with contextlib.redirect_stdout(io.StringIO()) as f:\n"
        "        runpy.run_path(f'{paper}/{name}.py', run_name='__main__')\n"
        "    out[name] = f.getvalue()\n"
        "plots = runpy.run_path(f'{paper}/modelnet40_plots.py')\n"
        "curves = {}\n"
        f"for d in sorted(__import__('os').listdir({str(out)!r})):\n"
        f"    scen = plots['load_scenario_from_dir'](__import__('os').path.join({str(out)!r}, d))\n"
        "    if scen is not None and scen.name == plots['SCENARIO_NAME']:\n"
        f"        c = plots['evaluate'](__import__('os').path.join({str(out)!r}, d), scen)\n"
        "        curves[scen.method.name] = {k: [float(x) for x in v] for k, v in c.items()}\n"
        "out['curves'] = curves\n"
        "print(json.dumps(out))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_PLATFORM_NAME="cpu", MPLBACKEND="Agg",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return out, ws, json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", sorted(TABLES))
def test_table_stdout_is_the_scripts_byte_for_byte(runs, name):
    out, _, ref = runs
    got = _capture(TABLES[name].main, [str(out)])
    assert got == ref[name]
    assert "DEEPCLR" in got or name == "kitti_odometry_table"
    assert "ICP_PO2PL" in got or name == "kitti_odometry_table"


def _printed_cells(text, labels):
    """{(row label, column name): number token} of a printed table.  Each
    header line names its block's columns (two or more spaces apart); a
    wrapped pandas frame repeats it a block, and pandas hides middle
    columns behind '...', which name no cell."""
    cells, header = {}, None
    for line in text.splitlines():
        tokens = line.split()
        if tokens and tokens[0] in labels and header is not None:
            assert len(tokens) == len(header) + 1, line
            cells.update(((tokens[0], c), t) for c, t in zip(header, tokens[1:]) if c != "...")
        elif line.startswith(" ") and line.strip():
            header = re.split(r"\s{2,}", line.strip().rstrip("\\").strip())
    return cells


def _half_unit(token):
    """Half a unit in the last printed digit of ``token``."""
    mantissa, _, exponent = token.lower().partition("e")
    return 0.5 * 10.0 ** (int(exponent or 0) - len(mantissa.partition(".")[2]))


def _expected(name, out):
    """{row label: {column: value}} the module's own evaluate gives."""
    if name == "kitti_odometry_table":
        directory, scenario = next((d, s) for d, s in _runs.scenario_runs(str(out), "kitti_04_10")
                                   if s.method.name == "DEEPCLR")
        errors = _runs.read_run(directory, scenario).get_step_errors()
        return {seq: {"t_rmse [m]": m.mean.translation.rmse, "r_rmse [deg]": np.rad2deg(m.mean.rotation.rmse)}
                for seq, m in errors.items()}
    module = TABLES[name]
    return {s.method.name: module.evaluate(d, s) for d, s in _runs.scenario_runs(str(out), module.SCENARIO_NAME)}


def test_tables_without_pandas_print_the_same_rows_and_numbers(runs):
    out, _, ref = runs
    code = (
        "import contextlib, io, json, sys\n"
        "sys.modules['pandas'] = None\n"
        "from deepclr_tpu_torch.paper import kitti_artificial_table, kitti_odometry_table, modelnet40_table\n"
        "out = {}\n"
        "for m in (kitti_artificial_table, kitti_odometry_table, modelnet40_table):\n"
        "    with contextlib.redirect_stdout(io.StringIO()) as f:\n"
        f"        m.main([{str(out)!r}])\n"
        "    out[m.__name__.rsplit('.', 1)[-1]] = f.getvalue()\n"
        "print(json.dumps(out))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    plain = json.loads(res.stdout.strip().splitlines()[-1])
    for name in TABLES:
        want = _expected(name, out)
        columns = list(next(iter(want.values())))
        lines = plain[name].splitlines()
        assert lines[0] == ref[name].splitlines()[0] and plain[name] != ref[name]
        cells = _printed_cells(plain[name], want)
        assert sorted(cells) == sorted((label, c) for label in want for c in columns), name
        for (label, column), token in cells.items():
            assert float(token) == float(want[label][column]) and token == _runs._field(want[label][column])
        shown = _printed_cells(ref[name], want)  # pandas: the columns it shows
        assert shown and all(label in want for label, _ in shown)
        for key, token in shown.items():
            assert abs(float(token) - float(cells[key])) <= _half_unit(token) * (1 + 1e-9), (name, key, token)
        if name == "kitti_odometry_table":  # the mean time line, as the script prints it
            assert lines[-1] == ref[name].splitlines()[-1]
            assert lines[-1].startswith("Average Inference Time: ")


def test_modelnet40_curves_equal_the_scripts_and_the_plots_are_written(runs, tmp_path, monkeypatch):
    out, _, ref = runs
    got = modelnet40_plots.curves(str(out))
    assert sorted(got) == sorted(ref["curves"]) == ["DEEPCLR", "ICP_PO2PL"]
    for method, curves in got.items():
        for metric in ("rotation", "translation"):
            assert len(curves[metric]) == len(modelnet40_plots.NOISE_LEVELS)
            np.testing.assert_allclose(curves[metric], ref["curves"][method][metric], rtol=0, atol=1e-12)
    monkeypatch.setenv("MPLBACKEND", "Agg")
    printed = _capture(modelnet40_plots.main, [str(out), "--output", str(tmp_path)])
    assert printed.strip() == f"Plots written to {tmp_path}"
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"modelnet40_{m}_vs_noise.{ext}" for m in ("rotation", "translation") for ext in ("pdf", "png"))


def test_cloud_figures_writes_its_two_renders(runs, tmp_path, monkeypatch):
    out, ws, _ = runs
    run_dir = next(d for d in sorted(os.listdir(out)) if d.endswith("kitti_04_10_DEEPCLR"))
    monkeypatch.setenv("MPLBACKEND", "Agg")
    prefix = str(tmp_path / "fig")
    printed = _capture(cloud_figures.main, [str(out / run_dir), str(ws / "kitti" / "odometry" / "04.pack"), "04",
                                            "--frame", "2", "--output", prefix])
    assert printed.splitlines() == [f"saved {prefix}_before.png", f"saved {prefix}_after.png"]
    assert sorted(os.listdir(tmp_path)) == ["fig_after.png", "fig_before.png"]
