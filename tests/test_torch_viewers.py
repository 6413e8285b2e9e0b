"""``python -m deepclr_tpu_torch.visualization.*`` against
``scripts/visualization/*.py`` on the CPU, headless (``MPLBACKEND=Agg``).

Each viewer of the port runs in process (the ``main()`` its ``python -m``
line calls) and each script in one subprocess (one jax import), on the
same inputs: the synthetic raw KITTI and ModelNet40 layouts of
``tests/scripts/test_viewers.py``, a small pair pack, and a training YAML
(two small sequence packs, the flagship's optimizer and schedule).  Each
writes the same file names as its script, and prints what its script
prints; ``view_scheduler``'s samples equal those of
``deepclr_tpu.solver.make_schedule`` within 1e-12.  Without matplotlib
(``sys.modules["matplotlib"] = None``) every figure and viewer module
still imports and answers ``--help``, and ``main`` exits non-zero with a
one-line message that names matplotlib.
"""
import contextlib
import io
import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from deepclr_tpu_torch.config import Mode, load_config  # noqa: E402
from deepclr_tpu_torch.data import PackWriter  # noqa: E402
from deepclr_tpu_torch.visualization import (show_kitti_odometry, show_modelnet40, view_dataflow,  # noqa: E402
                                             view_loader_output, view_scheduler)

from .scripts.test_viewers import _make_kitti, _make_modelnet  # noqa: E402

REPO = osp.realpath(osp.join(osp.dirname(__file__), ".."))
VIEWERS = {"show_kitti_odometry": show_kitti_odometry, "show_modelnet40": show_modelnet40,
           "view_dataflow": view_dataflow, "view_loader_output": view_loader_output,
           "view_scheduler": view_scheduler}
# every figure and viewer module, with positional arguments it accepts
FIGURES = {"deepclr_tpu_torch.paper.modelnet40_plots": ["x"], "deepclr_tpu_torch.paper.cloud_figures": ["x", "y", "z"],
           **{f"deepclr_tpu_torch.visualization.{name}": ["x", "y"] if name == "show_kitti_odometry" else ["x"]
              for name in VIEWERS}}


def _write_sequence(path, frames, seed):
    rng = np.random.default_rng(seed)
    with PackWriter(str(path)) as w:
        for i in range(frames):
            pose = np.eye(4)
            pose[0, 3] = float(i)
            w.put(f"{i:06d}", {"idx": i, "timestamp": i * 1e5, "pose": pose,
                               "cloud": (rng.normal(size=(80, 4)) * 5).astype(np.float32)})


def _write_pairs(path, pairs, seed):
    rng = np.random.default_rng(seed)
    with PackWriter(str(path)) as w:
        for i in range(pairs):
            m = np.eye(4)
            m[:3, 3] = rng.normal(size=3)
            w.put(f"{i:06d}", {"idx": [i, i + 1], "timestamps": [float(i), float(i + 1)],
                               "clouds": [rng.normal(size=(60, 4)).astype(np.float32),
                                          rng.normal(size=(70, 4)).astype(np.float32)], "transform": m})


def _training_yaml(ws):
    with open(osp.join(REPO, "configs", "training", "kitti_base.yaml")) as f:
        base = yaml.safe_load(f)
    cfg = {"base_dir": str(ws), "seed": 3, "device": "cpu",
           "data": {"training": str(ws / "00.pack"), "validation": str(ws / "01.pack"),
                    "dataset_type": "kitti_odometry_velodyne"},
           "transforms": {"translation_noise": {"scale": [0.1, 0.01, 0.01]},
                          "rotation_noise_deg": {"scale": [0.1, 0.1, 0.5]}},
           "data_loader": {"batch_size": 2, "num_points": 64, "num_workers": 0, "buffer_size": 0},
           "model": {"input_dim": 4, "point_dim": 3, "label_type": "pose3d_dual_quat", "model_type": "deepclr",
                     "params": {}},
           "optimizer": base["optimizer"], "scheduler": base["scheduler"]}
    path = ws / "train.yaml"
    with open(path, "w") as f:
        yaml.dump(cfg, f)
    return path


def _argv(ws, out):
    """Each viewer's arguments, its files going to ``out``."""
    return {
        "show_kitti_odometry": [str(ws / "kitti"), "00", "--save-dir", str(out)],
        "show_modelnet40": [str(ws / "modelnet" / "modelnet40_test.txt"), "--save-dir", str(out)],
        "view_dataflow": [str(ws / "pairs.pack"), "--num_samples", "2", "--save", str(out / "sample")],
        "view_loader_output": [str(ws / "train.yaml"), "--num_batches", "2", "--save", str(out / "batch")],
        "view_scheduler": [str(ws / "train.yaml"), "--output", str(out / "lr_schedule.png")],
    }


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The inputs, and the scripts' files, stdout and schedule samples:
    (workspace, {viewer: (files, stdout)}, (iterations, lrs))."""
    ws = tmp_path_factory.mktemp("viewers")
    _make_kitti(ws / "kitti")
    _make_modelnet(ws / "modelnet", shapes=("airplane", "bathtub"), per_shape=6)
    _write_pairs(ws / "pairs.pack", 3, seed=1)
    _write_sequence(ws / "00.pack", 6, seed=2)
    _write_sequence(ws / "01.pack", 4, seed=3)
    _training_yaml(ws)
    outs = {name: ws / "jax" / name for name in VIEWERS}
    for out in outs.values():
        out.mkdir(parents=True)
    argvs = {name: _argv(ws, out)[name] for name, out in outs.items()}
    code = (
        "import contextlib, io, json, os, runpy, sys\n"
        f"viz = {osp.join(REPO, 'scripts', 'visualization')!r}\n"
        "res = {}\n"
        f"for name, argv in {argvs!r}.items():\n"
        "    sys.argv = [name + '.py', *argv]\n"
        "    with contextlib.redirect_stdout(io.StringIO()) as f:\n"
        "        runpy.run_path(f'{viz}/{name}.py', run_name='__main__')\n"
        "    res[name] = f.getvalue()\n"
        "from deepclr_tpu.config import Mode, load_config\n"
        "from deepclr_tpu.solver import make_schedule\n"
        f"cfg = load_config({str(ws / 'train.yaml')!r}, Mode.TEST)\n"
        "schedule, max_it = make_schedule(cfg), cfg.optimizer.max_iterations or 100000\n"
        "import numpy as np\n"
        "steps = np.linspace(0, max_it, 2000, dtype=int)\n"
        "res['samples'] = [steps.tolist(), [float(schedule(int(s))) for s in steps]]\n"
        "print(json.dumps(res))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_PLATFORM_NAME="cpu", MPLBACKEND="Agg",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    return ws, {name: (sorted(os.listdir(out)), ref[name]) for name, out in outs.items()}, ref["samples"]


@pytest.mark.parametrize("name", list(VIEWERS))
def test_viewer_writes_the_scripts_files_headless(ws, name, tmp_path, monkeypatch):
    workspace, ref, _ = ws
    monkeypatch.setenv("MPLBACKEND", "Agg")
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        VIEWERS[name].main(_argv(workspace, tmp_path)[name])
    files, stdout = ref[name]
    assert files and sorted(os.listdir(tmp_path)) == files
    assert printed.getvalue().replace(str(tmp_path), "OUT") == stdout.replace(str(workspace / "jax" / name), "OUT")


def test_scheduler_samples_equal_jax(ws):
    workspace, _, (steps, lrs) = ws
    got_steps, got_lrs = view_scheduler.schedule_samples(load_config(str(workspace / "train.yaml"), Mode.TEST))
    assert got_steps.tolist() == steps and len(lrs) == 2000 and got_steps[-1] == 800000
    np.testing.assert_allclose(got_lrs, lrs, rtol=0, atol=1e-12)
    assert max(got_lrs) > 100 * min(got_lrs)  # the cyclic ramp and the annealing are sampled


def test_figures_and_viewers_need_matplotlib_only_to_draw():
    code = (
        "import contextlib, importlib, io, json, sys\n"
        "sys.modules['matplotlib'] = None\n"
        "res = {}\n"
        f"for name, args in {FIGURES!r}.items():\n"
        "    m = importlib.import_module(name)\n"
        "    codes = []\n"
        "    for argv in (['--help'], args):\n"
        "        err = io.StringIO()\n"
        "        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):\n"
        "            try:\n"
        "                m.main(argv)\n"
        "            except SystemExit as e:\n"
        "                codes.append([e.code if isinstance(e.code, int) else str(e.code), err.getvalue()])\n"
        "    res[name] = codes\n"
        "print(json.dumps(res))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert sorted(res) == sorted(FIGURES)
    for name, ((help_code, _), (message, _)) in res.items():
        assert help_code == 0, name
        assert isinstance(message, str) and "matplotlib" in message and "\n" not in message, (name, message)
