"""Contracts of the PyTorch port (deepclr_tpu_torch): it stands alone from
the JAX package, its entry points run on CUDA unless asked for the CPU, and
its kernels count only the launches a CUDA tensor makes."""
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import __graft_entry__  # noqa: E402
import deepclr_tpu_torch  # noqa: E402
from deepclr_tpu_torch import configs, ops  # noqa: E402
from deepclr_tpu_torch.device import resolve_device  # noqa: E402
from deepclr_tpu_torch.models import ModelInferenceHelper, build_model  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_neither_jax_nor_the_jax_package():
    modules = sorted(m.name for m in pkgutil.walk_packages(deepclr_tpu_torch.__path__, "deepclr_tpu_torch."))
    assert "deepclr_tpu_torch.models.deepclr" in modules and "deepclr_tpu_torch.ops._cuda" in modules
    assert {"deepclr_tpu_torch.losses", "deepclr_tpu_torch.solver.optimizers", "deepclr_tpu_torch.solver.build",
            "deepclr_tpu_torch.engine.trainer", "deepclr_tpu_torch.engine.checkpoint"} <= set(modules)
    assert {"deepclr_tpu_torch.inference", "deepclr_tpu_torch.config.schema", "deepclr_tpu_torch.data.pack",
            "deepclr_tpu_torch.data.datasets", "deepclr_tpu_torch.evaluation.evaluator",
            "deepclr_tpu_torch.evaluation.plot", "deepclr_tpu_torch.geometry.hostmath",
            "deepclr_tpu_torch.utils.logging", "deepclr_tpu_torch.utils.path"} <= set(modules)
    assert {"deepclr_tpu_torch.data.transforms", "deepclr_tpu_torch.data.batching", "deepclr_tpu_torch.data.loader",
            "deepclr_tpu_torch.data.synthetic", "deepclr_tpu_torch.training",
            "deepclr_tpu_torch.timing"} <= set(modules)
    assert {"deepclr_tpu_torch.ops.ball_grouping", "deepclr_tpu_torch.ops.interpolate",
            "deepclr_tpu_torch.models.feature_propagation", "deepclr_tpu_torch.models.flax_msgpack",
            "deepclr_tpu_torch.models.torch_convert", "deepclr_tpu_torch.convert_weights"} <= set(modules)
    assert {"deepclr_tpu_torch.icp.icp", "deepclr_tpu_torch.icp.cli", "deepclr_tpu_torch.icp.__main__",
            "deepclr_tpu_torch.native", "deepclr_tpu_torch.native.pack_reader", "deepclr_tpu_torch.native.morton_sort",
            "deepclr_tpu_torch.kitti_devkit.__main__", "deepclr_tpu_torch.kitti_devkit.plots",
            "deepclr_tpu_torch.evaluation.cli", "deepclr_tpu_torch.evaluation.__main__"} <= set(modules)
    assert {"deepclr_tpu_torch.parallel", "deepclr_tpu_torch.parallel.distributed", "deepclr_tpu_torch.parallel.mesh",
            "deepclr_tpu_torch.data.readers", "deepclr_tpu_torch.data.lmdb_reader", "deepclr_tpu_torch.utils.flops",
            "deepclr_tpu_torch.utils.profiling", "deepclr_tpu_torch.utils.tensor", "deepclr_tpu_torch.utils.factory",
            "deepclr_tpu_torch.utils.parsing", "deepclr_tpu_torch.utils.pcv"} <= set(modules)
    assert {f"deepclr_tpu_torch.paper.{m}" for m in ("_runs", "kitti_odometry_table", "kitti_artificial_table",
                                                     "modelnet40_table", "modelnet40_plots", "cloud_figures")} \
        | {f"deepclr_tpu_torch.visualization.{m}" for m in ("show_kitti_odometry", "show_modelnet40", "view_dataflow",
                                                            "view_loader_output", "view_scheduler")} <= set(modules)
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'deepclr_tpu'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_flagship_config_is_a_faithful_copy():
    assert configs.KITTI_MODEL_CFG == __graft_entry__.KITTI_MODEL_CFG


def test_flagship_training_recipe_is_a_faithful_copy():
    with open(REPO / "configs" / "training" / "kitti_base.yaml") as f:
        ref = yaml.safe_load(f)
    train = configs.KITTI_TRAIN_CFG
    for section in ("metrics", "optimizer", "scheduler", "logging"):
        assert train[section] == ref[section], section
    assert train["data_loader"] == {"batch_size": ref["data_loader"]["batch_size"]} == {"batch_size": 5}


def _small_cfg():
    cfg = json.loads(json.dumps(configs.KITTI_MODEL_CFG))
    cfg["params"]["cloud_features"]["params"]["npoint"] = [16]
    return cfg


def test_entry_points_default_to_cuda(tmp_path):
    """build_model runs on CUDA unless given device='cpu'; without a card it
    raises instead of falling back to the CPU.  So do training and timing
    from a YAML whose device is tpu or cuda: they raise before any run
    directory is written."""
    import faulthandler
    import signal

    from deepclr_tpu_torch import timing, training
    from deepclr_tpu_torch.config import Mode, load_config

    if torch.cuda.is_available():
        assert next(build_model(_small_cfg()).parameters()).is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(_small_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    from deepclr_tpu_torch.icp import ICPRegistration

    with pytest.raises(RuntimeError, match="CUDA"):
        ICPRegistration("gicp")

    for device in ("tpu", "cuda"):
        path = tmp_path / f"{device}.yaml"
        with open(path, "w") as f:
            yaml.dump({"base_dir": str(tmp_path / "models"), "device": device, "model": _small_cfg(),
                       "data": {"training": str(tmp_path / "none.pack"), "validation": str(tmp_path / "none.pack"),
                                "dataset_type": "kitti_odometry_velodyne"},
                       "optimizer": {"max_iterations": 2}}, f)
        with pytest.raises(RuntimeError, match="CUDA"):
            training.train(load_config(str(path), Mode.NEW))
        sigint = signal.getsignal(signal.SIGINT)
        try:
            with pytest.raises(RuntimeError, match="CUDA"):
                training.main([str(path)])
        finally:  # main installs the run's SIGINT handler and the SIGUSR1 stack dump
            signal.signal(signal.SIGINT, sigint)
            faulthandler.unregister(signal.SIGUSR1)
        with pytest.raises(RuntimeError, match="CUDA"):
            timing.main([str(path)])
    assert not (tmp_path / "models").exists()


def test_cpu_path_runs_plain_versions_and_counts_no_launch():
    model = build_model(_small_cfg(), device="cpu")
    assert not any(p.is_cuda for p in model.parameters())
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    clouds = [rng.normal(size=(200, 4)).astype(np.float32) for _ in range(2)]
    y = ModelInferenceHelper(model, num_points=256).predict_batch(clouds[:1], clouds[1:])
    assert y.shape == (1, 8) and np.isfinite(y).all()
    assert ops.launch_counts() == {"fps": 0, "min_d2": 0, "fused_sa": 0, "fused_sa_argmax": 0,
                                   "fused_sa_bwd": 0, "fused_sa_bwd_finish": 0, "gather_bwd_index": 0,
                                   "gather_bwd": 0}


def test_init_params_is_seeded():
    a = build_model(_small_cfg(), device="cpu", seed=3).state_dict()
    b = build_model(_small_cfg(), device="cpu", seed=3).state_dict()
    c = build_model(_small_cfg(), device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["_merge_layers.0._embedding._conv._sequential.0._sequential.0.weight"],
                           c["_merge_layers.0._embedding._conv._sequential.0._sequential.0.weight"])
    # the pose head starts at the identity dual quaternion
    assert a["_merge_layers.1.output.bias"].tolist() == [1.0, 0, 0, 0, 0, 0, 0, 0]


def _changed_cfg(change):
    cfg = _small_cfg()
    where, key, value = change
    section = cfg["params"] if where == "params" else cfg["params"][where]["params"]
    section[key] = value
    return cfg


@pytest.mark.parametrize("change", [
    # batch norm in set abstraction raises in the JAX package too (at init)
    ("params", "batch_norm", True),
    ("params", "output", {"name": "OutputFC", "params": {}}),
    ("params", "loss", {"name": "ChamferLoss"}),
])
def test_build_rejects_configs_outside_the_slice(change):
    with pytest.raises(NotImplementedError):
        build_model(_changed_cfg(change), device="cpu")


@pytest.mark.parametrize("change", [
    ("params", "fused", False),
    ("merge", "k", 0),
    ("merge", "append_features", False),
])
def test_model_variants_build_and_predict(change):
    """The exact set abstraction, k=0 and append_features=False build and
    serve (tests/test_torch_model_variants.py holds them against JAX)."""
    model = build_model(_changed_cfg(change), device="cpu")
    rng = np.random.default_rng(0)
    clouds = [rng.normal(size=(200, 4)).astype(np.float32) for _ in range(2)]
    y = ModelInferenceHelper(model, num_points=256).predict_batch(clouds[:1], clouds[1:])
    assert y.shape == (1, 8) and np.isfinite(y).all()


def test_inference_entry_point_imports_without_yaml_or_matplotlib():
    """The CLI modules, the evaluation package, the helpers, the paper
    tables and figures and the viewers import with PyYAML, matplotlib and
    pandas unavailable (the card machine may lack them)."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('yaml', 'matplotlib', 'pandas'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import deepclr_tpu_torch.inference, deepclr_tpu_torch.evaluation, deepclr_tpu_torch.config\n"
        "import deepclr_tpu_torch.evaluation.cli, deepclr_tpu_torch.icp.cli, deepclr_tpu_torch.kitti_devkit.__main__\n"
        "import deepclr_tpu_torch.paper.kitti_odometry_table, deepclr_tpu_torch.paper.kitti_artificial_table\n"
        "import deepclr_tpu_torch.paper.modelnet40_table, deepclr_tpu_torch.paper.modelnet40_plots\n"
        "import deepclr_tpu_torch.paper.cloud_figures, deepclr_tpu_torch.visualization.view_scheduler\n"
        "import deepclr_tpu_torch.visualization.show_kitti_odometry, deepclr_tpu_torch.visualization.view_dataflow\n"
        "import deepclr_tpu_torch.visualization.show_modelnet40, deepclr_tpu_torch.visualization.view_loader_output\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in ('yaml', 'matplotlib', 'pandas')))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_presorted_config_builds():
    cfg = _small_cfg()
    cfg["params"]["presorted"] = True
    model = build_model(cfg, device="cpu")
    assert model.cloud_features.presorted and model.cloud_features._sa0.presorted


def _dropout_cfg():
    cfg = _small_cfg()
    cfg["params"]["dropout"] = 0.5
    return cfg


def test_dropout_config_builds_and_serves_as_without_dropout():
    """Dropout acts only in training, so a dropout config serves exactly as
    the same config without it."""
    rng = np.random.default_rng(1)
    clouds = [rng.normal(size=(200, 4)).astype(np.float32) for _ in range(2)]
    ys = [ModelInferenceHelper(build_model(cfg, device="cpu", seed=2), num_points=256)
          .predict_batch(clouds[:1], clouds[1:]) for cfg in (_dropout_cfg(), _small_cfg())]
    assert np.array_equal(ys[0], ys[1])
