"""Evaluation scenario configs: {name, dataset_type, sequential,
data{sequence: pack path}, method{name, params}}."""
from __future__ import annotations

from typing import Any, Dict

from ..config.config import Config
from ..data.types import DatasetType
from ..utils.path import expand_path

__all__ = ["load_scenario", "scenario_from_dict"]


def _schema(with_method: bool) -> Config:
    cfg = Config(allow_dynamic_params=True)
    cfg.define_param("name", required=True)
    cfg.define_param("dataset_type", required=True)
    cfg.define_param("sequential", required=True)
    cfg.define_param("data", required=True)

    method_grp = cfg.define_group("method")
    cfg.define_param("name", parent=method_grp, required=with_method)
    cfg.define_group("params", parent=method_grp)
    return cfg


def _finish(cfg: Config) -> Config:
    if not cfg.is_valid():
        raise RuntimeError(
            "Configuration is not valid, missing required parameters: "
            + ", ".join(cfg.missing_params())
        )
    cfg.dataset_type = DatasetType.create(cfg.dataset_type)
    cfg.data = {k: expand_path(v) for k, v in cfg.data.items()}
    cfg.freeze()
    return cfg


def load_scenario(filename: str, with_method: bool = False) -> Config:
    """Load a scenario YAML file (needs PyYAML)."""
    cfg = _schema(with_method)
    cfg.read_file(filename)
    return _finish(cfg)


def scenario_from_dict(d: Dict[str, Any], with_method: bool = False) -> Config:
    """The scenario of a plain dict, validated as ``load_scenario`` does;
    needs no YAML package."""
    cfg = _schema(with_method)
    cfg.read_dict(d)
    return _finish(cfg)
