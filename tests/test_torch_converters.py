"""The port's data CLIs against the JAX package's scripts, on the CPU, at the
sizes of ``tests/scripts/test_converters.py`` (2 sequences of 12 frames of
512 points; 1 + 1 ModelNet40 models a shape of 2100 points, the converters
on four shapes' models):

* ``make_synthetic_kitti`` / ``make_synthetic_modelnet`` write byte-identical
  raw files for the same seed;
* every converter's pack is byte-identical on the same raw input; the two
  unseeded perturbation converters are seeded on both sides by patching
  ``numpy.random.default_rng`` for the call (the scripts stay unseeded);
* ``export_kitti_poses`` writes equal pose files;
* each inference example, on the same ``weights.msgpack``, predicts what
  the JAX example predicts within the whole-model bound (1e-5, float32).

Everything runs in process, with its environment contract (``KITTI_PATH``,
``MODELNET40_PATH``, ``MODEL_PATH``) and argv: a JAX script through
``runpy`` as ``__main__``, a module of the port through the ``main()`` its
``python -m`` line calls."""
import copy
import filecmp
import importlib
import os
import os.path as osp
import runpy
import shutil
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deepclr_tpu.evaluation import Evaluator as JaxEvaluator  # noqa: E402
from deepclr_tpu.models import ModelInferenceHelper as JaxHelper  # noqa: E402
from deepclr_tpu.models import build_model as jax_build_model, init_params as jax_init_params  # noqa: E402
from deepclr_tpu.models import save_weights as jax_save_weights  # noqa: E402
from deepclr_tpu_torch.data import DatasetType, create_input_dataflow  # noqa: E402
from deepclr_tpu_torch.models import ModelInferenceHelper  # noqa: E402

REPO = osp.realpath(osp.join(osp.dirname(__file__), ".."))
SCRIPTS = osp.join(REPO, "scripts")
KITTI_ARGS = ["--sequences", "00,01", "--frames", "12", "--points", "512"]
MODELNET_ARGS = ["--train-per-shape", "1", "--test-per-shape", "1", "--points", "2100"]
EXAMPLE_TOL = 1e-5  # the whole-model bound, float32


def _run(target, argv, monkeypatch, env=None):
    """A JAX script (``python target``, run as ``__main__``) or the ``main()``
    of a module of the port (what ``python -m target`` calls), in process."""
    monkeypatch.setattr(sys, "argv", [target, *argv])
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    if target.endswith(".py"):
        runpy.run_path(target, run_name="__main__")
    else:
        importlib.import_module(target).main()


def _seeded(monkeypatch, seed=11):
    """numpy.random.default_rng() without a seed draws from ``seed``."""
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda s=None: real(seed if s is None else s))


def _tree(root):
    return sorted(osp.relpath(osp.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def _same_tree(a, b):
    files = _tree(a)
    assert files and files == _tree(b)
    differ = [f for f in files if not filecmp.cmp(osp.join(a, f), osp.join(b, f), shallow=False)]
    assert not differ, differ


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    ws = tmp_path_factory.mktemp("kitti_cli")
    with pytest.MonkeyPatch.context() as mp:
        _run(osp.join(SCRIPTS, "make_synthetic_kitti.py"), [str(ws / "jax"), *KITTI_ARGS], mp)
        _run("deepclr_tpu_torch.make_synthetic_kitti", [str(ws / "port"), *KITTI_ARGS], mp)
    return ws


@pytest.fixture(scope="module")
def modelnet(tmp_path_factory):
    ws = tmp_path_factory.mktemp("modelnet_cli")
    with pytest.MonkeyPatch.context() as mp:
        _run(osp.join(SCRIPTS, "make_synthetic_modelnet.py"), [str(ws / "jax"), *MODELNET_ARGS], mp)
        _run("deepclr_tpu_torch.make_synthetic_modelnet", [str(ws / "port"), *MODELNET_ARGS], mp)
    return ws


def test_synthetic_raw_files_are_byte_identical(kitti, modelnet):
    _same_tree(str(kitti / "jax" / "original"), str(kitti / "port" / "original"))
    assert len(os.listdir(kitti / "port" / "original" / "sequences" / "00" / "velodyne")) == 12
    _same_tree(str(modelnet / "jax" / "original"), str(modelnet / "port" / "original"))


def test_kitti_converters_write_the_same_packs(kitti, monkeypatch):
    for name, out in (("kitti_odometry", "odometry"), ("kitti_pairs", "pairs"), ("kitti_pairs_test", "pairs_test")):
        for side, target in (("jax", osp.join(SCRIPTS, "converter", f"{name}.py")),
                             ("port", f"deepclr_tpu_torch.converter.{name}")):
            with monkeypatch.context() as mp:
                _seeded(mp)
                _run(target, [], mp, {"KITTI_PATH": str(kitti / side)})
        _same_tree(str(kitti / "jax" / out), str(kitti / "port" / out))
    pairs = list(create_input_dataflow(DatasetType.KITTI_ODOMETRY_VELODYNE,
                                       str(kitti / "port" / "odometry" / "00.pack")))
    assert len(pairs) == 11 and pairs[0]["clouds"][0].shape == (256, 4)
    perturbed = list(create_input_dataflow(DatasetType.GENERIC, str(kitti / "port" / "pairs_test" / "00.pack")))
    assert len(perturbed) >= 2 and max(np.linalg.norm(s["transform"][:3, 3]) for s in perturbed) > 0.05


def _modelnet_subset(modelnet, root):
    """The raw layout with its listings cut to two seen and two unseen
    shapes (the converters' host FPS takes ~0.2 s a model), the same for
    both sides."""
    keep = ("airplane", "bathtub", "laptop", "mantel")
    for side in ("jax", "port"):
        shutil.copytree(modelnet / side / "original", root / side / "original")
        for listing in ("modelnet40_train.txt", "modelnet40_test.txt"):
            path = root / side / "original" / listing
            names = [n for n in path.read_text().split() if n.rpartition("_")[0] in keep]
            path.write_text("\n".join(names) + "\n")


def test_modelnet_converters_write_the_same_packs(modelnet, tmp_path, monkeypatch):
    _modelnet_subset(modelnet, tmp_path)
    for name, out in (("modelnet40", "models"), ("modelnet40_test", "test")):
        for side, target in (("jax", osp.join(SCRIPTS, "converter", f"{name}.py")),
                             ("port", f"deepclr_tpu_torch.converter.{name}")):
            with monkeypatch.context() as mp:
                _seeded(mp)
                _run(target, [], mp, {"MODELNET40_PATH": str(tmp_path / side)})
        _same_tree(str(tmp_path / "jax" / out), str(tmp_path / "port" / out))
    assert len(os.listdir(tmp_path / "port" / "test")) == 22
    samples = list(create_input_dataflow(DatasetType.MODELNET40, str(tmp_path / "port" / "models" / "train.pack")))
    assert len(samples) == 2 and samples[0]["clouds"][0].shape[0] == 2048


def test_lmdb_to_pack_writes_the_same_pack(tmp_path, monkeypatch):
    from tests.data.test_lmdb_import import _msgpack_numpy, _write_lmdb

    rng = np.random.default_rng(0)
    keys = [f"{i:08d}".encode() for i in range(3)]
    entries = [(k, _msgpack_numpy({b"idx": i, b"timestamp": float(i), b"pose": np.eye(4),
                                   b"cloud": rng.normal(size=(700, 4)).astype(np.float32)}))
               for i, k in enumerate(keys)]
    _write_lmdb(tmp_path / "00.lmdb", entries + [(b"__keys__", _msgpack_numpy(keys))])
    _run(osp.join(SCRIPTS, "converter", "lmdb_to_pack.py"), [str(tmp_path / "00.lmdb"), str(tmp_path / "jax.pack")],
         monkeypatch)
    _run("deepclr_tpu_torch.converter.lmdb_to_pack", [str(tmp_path / "00.lmdb"), str(tmp_path / "port.pack")],
         monkeypatch)
    assert filecmp.cmp(tmp_path / "jax.pack", tmp_path / "port.pack", shallow=False)


def test_export_kitti_poses_writes_the_same_files(kitti, tmp_path, monkeypatch):
    """Predictions of sequences 00 and 01 (ground truth with a drift) in an
    inference output directory, exported by both against the raw layout's
    calibration."""
    rng = np.random.default_rng(5)
    ev = JaxEvaluator()
    for seq in ("00", "01"):
        poses = np.loadtxt(kitti / "jax" / "original" / "poses" / f"{seq}.txt").reshape(-1, 3, 4)
        for i in range(1, len(poses)):
            gt = np.eye(4)
            gt[:3] = poses[i]
            prev = np.eye(4)
            prev[:3] = poses[i - 1]
            step = np.linalg.inv(prev) @ gt
            pred = step.copy()
            pred[:3, 3] += rng.normal(scale=0.01, size=3)
            ev.add_transforms(seq, 0.1 * i, pred, step)
    for side in ("jax", "port"):
        ev.write(str(tmp_path / side))
    _run(osp.join(SCRIPTS, "export_kitti_poses.py"), [str(tmp_path / "jax")], monkeypatch,
         {"KITTI_PATH": str(kitti / "jax")})
    _run("deepclr_tpu_torch.export_kitti_poses", [str(tmp_path / "port")], monkeypatch,
         {"KITTI_PATH": str(kitti / "port")})
    assert sorted(os.listdir(tmp_path / "port" / "kitti")) == ["00.txt", "01.txt"]
    _same_tree(str(tmp_path / "jax" / "kitti"), str(tmp_path / "port" / "kitti"))


MODEL_CFG = {
    "input_dim": 4, "point_dim": 3, "label_type": "pose3d_dual_quat", "model_type": "deepclr",
    "params": {
        "batch_norm": False, "dropout": 1.0, "compute_dtype": "float32",
        "cloud_features": {"name": "SetAbstraction", "params": {
            "npoint": [32], "radii": [[1.0, 2.0]], "nsamples": [[8, 16]], "mlps": [[[8, 8, 16], [8, 8, 16]]]}},
        "merge": {"name": "MotionEmbedding", "params": {"k": 4, "radius": 10.0, "mlp": [16, 32]}},
        "output": {"name": "OutputSimple", "params": {"mlp": [32, 64], "linear": [64, 32]}},
    },
}


def _model_dir(root, name, input_dim, num_points):
    """MODEL_PATH/name with model_config.yaml and a JAX weights.msgpack
    (seeded initialisation, biases made non-zero)."""
    cfg = copy.deepcopy(MODEL_CFG)
    cfg["input_dim"] = input_dim
    path = root / name
    path.mkdir(parents=True)
    with open(path / "model_config.yaml", "w") as f:
        yaml.dump(cfg, f)
    variables = jax_init_params(jax_build_model(cfg), jax.random.PRNGKey(3), num_points=num_points)
    rng = np.random.default_rng(4)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, x: x + rng.normal(scale=0.1, size=x.shape).astype(x.dtype) if "bias" in jax.tree_util.keystr(p)
        else x, variables)
    jax_save_weights(str(path / "weights.msgpack"), variables)


def _recorded(monkeypatch, cls):
    seen = []
    predict = cls.predict

    def wrapper(self, *args, **kwargs):
        y = predict(self, *args, **kwargs)
        seen.append(None if y is None else np.asarray(y, np.float64))
        return y

    monkeypatch.setattr(cls, "predict", wrapper)
    return seen


@pytest.mark.parametrize("example", ["kitti", "modelnet40"])
def test_examples_predict_what_the_jax_examples_predict(example, kitti, modelnet, tmp_path, monkeypatch):
    if example == "kitti":
        _model_dir(tmp_path, "m", 4, 16384)
        env = {"KITTI_PATH": str(kitti / "jax"), "MODEL_PATH": str(tmp_path)}
        argv = ["m", "--sequence", "00", "--num_frames", "4"]
    else:
        _model_dir(tmp_path, "m", 3, 2048)
        env = {"MODELNET40_PATH": str(modelnet / "jax"), "MODEL_PATH": str(tmp_path)}
        argv = ["m", "--num_samples", "3"]
    preds = {}
    for side, target, extra in (("jax", osp.join(SCRIPTS, "examples", f"{example}_inference.py"), []),
                                ("port", f"deepclr_tpu_torch.examples.{example}_inference", ["--device", "cpu"])):
        with monkeypatch.context() as mp:
            _seeded(mp)
            preds[side] = _recorded(mp, JaxHelper if side == "jax" else ModelInferenceHelper)
            _run(target, argv + extra, mp, env)
    assert len(preds["port"]) == len(preds["jax"]) >= 3
    for got, want in zip(preds["port"], preds["jax"]):
        if want is None:
            assert got is None
            continue
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=EXAMPLE_TOL * max(1.0, np.abs(want).max()))
