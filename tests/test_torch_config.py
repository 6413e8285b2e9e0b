"""The port's configuration modules against the JAX package's: every
training and scenario YAML of the repository, model configs, the device
mapping and the required keys."""
import glob
import os.path as osp

import numpy as np
import pytest
import yaml

pytest.importorskip("torch")

from deepclr_tpu.config import Config as JaxConfig, Mode as JaxMode  # noqa: E402
from deepclr_tpu.config import load_config as jax_load_config, load_model_config as jax_load_model_config  # noqa: E402
from deepclr_tpu.evaluation import load_scenario as jax_load_scenario  # noqa: E402
from deepclr_tpu_torch.config import (Config, Mode, create_default_config, finish_config, load_config,  # noqa: E402
                                      load_model_config)
from deepclr_tpu_torch.data import DatasetType  # noqa: E402
from deepclr_tpu_torch.evaluation import load_scenario, scenario_from_dict  # noqa: E402
from deepclr_tpu_torch.geometry import LabelType  # noqa: E402
from deepclr_tpu_torch.losses import MetricType  # noqa: E402
from deepclr_tpu_torch.models import ModelType, build_model  # noqa: E402

REPO = osp.realpath(osp.join(osp.dirname(__file__), ".."))
TRAINING = sorted(glob.glob(osp.join(REPO, "configs", "training", "*.yaml")))
SCENARIOS = sorted(glob.glob(osp.join(REPO, "configs", "scenarios", "*.yaml")))


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("MODEL_PATH", str(tmp_path / "models"))
    monkeypatch.setenv("KITTI_PATH", str(tmp_path / "kitti"))
    monkeypatch.setenv("MODELNET40_PATH", str(tmp_path / "modelnet40"))


def test_every_config_of_the_repository_is_covered():
    assert len(TRAINING) >= 9 and len(SCENARIOS) >= 11


@pytest.mark.parametrize("path", TRAINING, ids=osp.basename)
def test_training_configs_load_as_in_jax(path):
    got = load_config(path, Mode.TEST)
    ref = jax_load_config(path, JaxMode.TEST)
    assert got.is_frozen() and ref.is_frozen()
    # the enums are serialised by value, i.e. compared by name
    g, r = got.to_dict(), ref.to_dict()
    assert g.pop("device") == "cuda" and r.pop("device") in ("tpu", "cuda")
    assert g == r
    assert isinstance(got.model.label_type, LabelType) and isinstance(got.model.model_type, ModelType)
    assert all(isinstance(e["type"], MetricType) for e in got.metrics.loss + got.metrics.other)
    assert got.data.dataset_type is None or isinstance(got.data.dataset_type, DatasetType)


@pytest.mark.parametrize("path", SCENARIOS, ids=osp.basename)
def test_scenarios_load_as_in_jax(path):
    got = load_scenario(path)
    assert got.to_dict() == jax_load_scenario(path).to_dict()
    assert isinstance(got.dataset_type, DatasetType) and got.is_frozen()
    with open(path) as f:
        assert scenario_from_dict(yaml.safe_load(f)).to_dict() == got.to_dict()


def test_model_config_loads_as_in_jax(tmp_path):
    with open(osp.join(REPO, "configs", "training", "kitti_base.yaml")) as f:
        model = yaml.safe_load(f)["model"]
    path = tmp_path / "model_config.yaml"
    with open(path, "w") as f:
        yaml.dump(model, f)
    got = load_model_config(str(path), "${MODEL_PATH}/toy/weights.pt")
    ref = jax_load_model_config(str(path), "${MODEL_PATH}/toy/weights.pt")
    assert got.to_dict() == ref.to_dict()
    assert got.weights == str(tmp_path / "models" / "toy" / "weights.pt")
    assert got.label_type == LabelType.POSE3D_DUAL_QUAT and got.model_type == ModelType.DEEPCLR
    # the Config tree builds the model it describes
    cfg = got.to_dict()
    cfg["params"]["cloud_features"]["params"]["npoint"] = [16]
    assert build_model(cfg, device="cpu").cloud_features._sa0.npoint == 16


@pytest.mark.parametrize("device, expected", [("tpu", "cuda"), ("cuda", "cuda"), ("CUDA", "cuda"),
                                              ("cpu", "cpu"), (None, "cuda"), ("gpu", None), ("cuda:1", None)])
def test_device_mapping(device, expected):
    cfg = create_default_config(Mode.TEST)
    d = {"base_dir": "/tmp", "model": {"label_type": "pose3d_quat", "model_type": "deepclr"}}
    if device is not None:
        d["device"] = device
    cfg.read_dict(d)
    if expected is None:
        with pytest.raises(RuntimeError, match="device"):
            finish_config(cfg)
    else:
        finish_config(cfg)
        assert cfg.device == expected


# finish_config resolves base_dir and the data paths (setting them, to None if
# absent), so a missing one shows only where it is used; these keys raise
@pytest.mark.parametrize("missing, mode, match", [
    ("data.dataset_type", "NEW", "missing required parameters: data.dataset_type"),
    ("model.label_type", "TEST", "'none' is not a valid LabelType"),
    ("model.model_type", "TEST", "'none' is not a valid ModelType"),
])
def test_a_missing_required_key_raises(tmp_path, missing, mode, match):
    d = {"base_dir": "/tmp", "data": {"training": "/tmp/a.pack", "dataset_type": "generic"},
         "model": {"label_type": "pose3d_quat", "model_type": "deepclr"}, "optimizer": {"max_iterations": 10}}
    group, _, key = missing.rpartition(".")
    del (d[group] if group else d)[key]
    path = tmp_path / "cfg.yaml"
    with open(path, "w") as f:
        yaml.dump(d, f)
    for load, m in ((load_config, Mode[mode]), (jax_load_config, JaxMode[mode])):
        with pytest.raises((RuntimeError, ValueError), match=match):
            load(str(path), m)


def test_a_scenario_without_data_raises():
    with pytest.raises(RuntimeError, match="missing required parameters: data"):
        scenario_from_dict({"name": "x", "dataset_type": "generic", "sequential": False})
    with pytest.raises(RuntimeError, match="method.name"):
        scenario_from_dict({"name": "x", "dataset_type": "generic", "sequential": False, "data": {}},
                           with_method=True)


def test_config_tree_behaves_as_jax(tmp_path):
    trees = []
    for cls in (Config, JaxConfig):
        cfg = cls(allow_dynamic_params=True)
        grp = cfg.define_group("optimizer")
        cfg.define_param("base_lr", parent=grp, default=1e-4)
        cfg.define_param("needed", required=True)
        assert not cfg.is_valid() and cfg.missing_params() == ["needed"]
        cfg.read_dict({"needed": np.float32(2.0), "optimizer": {"params": {"a": 1}}, "extra": {"x": [1, 2]}})
        cfg.read_list(["optimizer.base_lr", "0.5", "extra.x", "[3, 4]"])
        cfg.freeze()
        with pytest.raises(RuntimeError):
            cfg.needed = 1
        cfg.write_file(str(tmp_path / "out.yaml"))
        with open(tmp_path / "out.yaml") as f:
            trees.append((cfg.to_dict(), f.read()))
    assert trees[0] == trees[1]
    assert trees[0][0]["optimizer"] == {"base_lr": 0.5, "params": {"a": 1}}
