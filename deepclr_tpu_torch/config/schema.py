"""Default configuration schema and loading pipeline.

The group and parameter names of the JAX package's schema, so its training
configs and ``model_config.yaml`` files load unchanged.  ``device`` defaults
to ``"cuda"``; ``finish_config`` maps ``"tpu"`` and ``"cuda"`` to
``"cuda"`` and ``"cpu"`` to ``"cpu"``, and raises on anything else.
"""
from __future__ import annotations

import enum
import os.path as osp
import subprocess
from datetime import datetime
from typing import Optional

import numpy as np

from ..data.types import DatasetType
from ..geometry import LabelType
from ..losses import MetricType
from ..models.build import ModelType
from ..utils.path import expand_path
from .config import Config

__all__ = ["Mode", "create_default_config", "read_config", "finish_config",
           "load_config", "load_model_config"]

_DEVICES = {"tpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


class Mode(enum.Enum):
    """Configuration mode controlling which parameters are required."""

    NEW = "new"
    CONTINUE = "continue"
    INFERENCE = "inference"
    TEST = "test"


def create_default_config(mode: Mode) -> Config:
    """Declare the full parameter schema with defaults and required flags."""
    cfg = Config(allow_dynamic_params=True)

    # general
    cfg.define_param("extends", default=None)
    cfg.add_internal_param("mode", value=mode)
    cfg.define_param("base_dir", required=True)
    cfg.define_param("identifier", default=None)
    cfg.add_internal_param("experiment", value=None)
    cfg.define_param("checkpoint")
    cfg.define_param("device", default="cuda")
    cfg.define_param("seed", default=0)

    # data
    training_required = mode in (Mode.NEW, Mode.CONTINUE)
    data_grp = cfg.define_group("data")
    cfg.define_param("training", parent=data_grp, required=training_required)
    cfg.define_param("validation", parent=data_grp, required=False)
    cfg.define_param("dataset_type", parent=data_grp, required=training_required)
    cfg.define_param("sequential", parent=data_grp, default=False)

    # transforms
    t = cfg.define_group("transforms")
    cfg.define_param("on_validation", parent=t, default=False)
    cfg.define_param("nth_point", parent=t, default=1)
    cfg.define_param("nth_point_random", parent=t, default=False)
    cfg.define_param("min_range", parent=t, default=0.0)
    cfg.define_param("max_range", parent=t, default=np.inf)
    cfg.define_param("keep_probability", parent=t, default=1.0)
    cfg.define_param("max_points", parent=t, default=np.inf)
    cfg.define_param("fps", parent=t, default=np.inf)
    cfg.define_param("remove_transform", parent=t, default=False)

    pn = cfg.define_group("point_noise", parent=t)
    cfg.define_param("type", parent=pn, default="normal")
    cfg.define_param("scale", parent=pn, default=0.0)
    cfg.define_param("target_only", parent=pn, default=False)

    tn = cfg.define_group("translation_noise", parent=t)
    cfg.define_param("type", parent=tn, default="normal")
    cfg.define_param("scale", parent=tn, default=[0.0, 0.0, 0.0])

    rn = cfg.define_group("rotation_noise_deg", parent=t)
    cfg.define_param("type", parent=rn, default="normal")
    cfg.define_param("scale", parent=rn, default=[0.0, 0.0, 0.0])

    # data loader (num_points: the fixed padded cloud size)
    dl = cfg.define_group("data_loader")
    cfg.define_param("parallel_loading", parent=dl, default=False)
    cfg.define_param("num_workers", parent=dl, default=0)
    cfg.define_param("batch_size", parent=dl, default=1)
    cfg.define_param("buffer_size", parent=dl, default=0)
    cfg.define_param("num_points", parent=dl, default=None)
    cfg.define_param("worker_type", parent=dl, default="thread")

    # model
    m = cfg.define_group("model")
    cfg.define_param("weights", parent=m)
    cfg.define_param("input_dim", parent=m, default=3)
    cfg.define_param("point_dim", parent=m, default=3)
    cfg.define_param("label_type", parent=m, required=True)
    cfg.define_param("model_type", parent=m, required=True)
    cfg.define_group("params", parent=m)

    # metrics
    me = cfg.define_group("metrics")
    cfg.define_param("loss", parent=me, default=[])
    cfg.define_param("other", parent=me, default=[])
    cfg.define_param("running_average_alpha", parent=me, default=0.5)

    # optimizer (weight_ema_decay: Polyak weight averaging, 0.0 = off)
    o = cfg.define_group("optimizer")
    cfg.define_param("name", parent=o, default="Adam")
    cfg.define_param("max_epochs", parent=o)
    cfg.define_param("max_iterations", parent=o)
    cfg.define_param("base_lr", parent=o, default=0.0001)
    cfg.define_param("weight_decay", parent=o, default=0.0)
    cfg.define_param("bias_lr_factor", parent=o, default=2.0)
    cfg.define_param("weight_decay_bias", parent=o, default=0.0)
    cfg.define_param("accumulation_steps", parent=o, default=1)
    cfg.define_param("weight_ema_decay", parent=o, default=0.0)
    cfg.define_param("params", parent=o, default={})

    # scheduler
    s = cfg.define_group("scheduler")
    cfg.define_param("epoch", parent=s, default=None)
    cfg.define_param("iteration", parent=s, default=None)
    cfg.define_param("name", parent=s, default=None)
    cfg.define_param("on_iteration", parent=s, default=False)
    cfg.define_param("on_validation", parent=s, default=False)
    cfg.define_param("needs_metrics", parent=s, default=False)
    cfg.define_param("warmup_iterations", parent=s, default=0)
    cfg.define_param("warmup_multiplier", parent=s, default=1.0)
    cfg.define_param("params", parent=s, default={})

    # logging
    lg = cfg.define_group("logging")
    cfg.define_param("add_graph", parent=lg, default=False)
    cfg.define_param("summary_period", parent=lg, default=5)
    cfg.define_param("log_period", parent=lg, default=1000)
    cfg.define_param("checkpoint_period", parent=lg, default=1000)
    cfg.define_param("checkpoint_n_saved", parent=lg, default=10)
    cfg.define_param("validation_period", parent=lg, default=5000)

    return cfg


def read_config(cfg: Config, filename: str) -> None:
    """Read YAML, resolving recursive ``extends:`` inheritance first."""
    import yaml

    with open(filename, "r") as f:
        d = yaml.load(f, Loader=yaml.Loader)
    d = d or {}

    if d.get("extends"):
        parent = osp.realpath(osp.join(osp.dirname(filename), d["extends"]))
        if osp.realpath(filename) != parent:
            read_config(cfg, parent)

    mode = cfg.mode
    cfg.read_dict(d)
    cfg.mode = mode
    cfg.extends = None


def _git_commit() -> Optional[str]:
    here = osp.dirname(osp.realpath(__file__))
    try:
        out = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=here, stderr=subprocess.DEVNULL
        )
        return out.decode("utf-8").split("\n")[0]
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None


def _device(value) -> str:
    key = str(value).lower()
    if key not in _DEVICES:
        raise RuntimeError(f"Unsupported device '{value}': expected one of {sorted(_DEVICES)}")
    return _DEVICES[key]


def finish_config(cfg: Config) -> None:
    """Resolve paths and the device, stamp the experiment, validate and freeze."""
    if cfg.extends is not None:
        raise RuntimeError("The extended config file was not loaded")

    if cfg.mode == Mode.CONTINUE and cfg.checkpoint is None:
        raise RuntimeError("Please specify the checkpoint for continue")
    if cfg.mode == Mode.INFERENCE and cfg.model.weights is None:
        raise RuntimeError("Please specify the model weights for inference")

    cfg.device = _device(cfg.device)
    cfg.base_dir = expand_path(cfg.base_dir)
    cfg.checkpoint = expand_path(cfg.checkpoint)
    cfg.model.weights = expand_path(cfg.model.weights)
    cfg.data.training = expand_path(cfg.data.training)
    cfg.data.validation = expand_path(cfg.data.validation)

    if cfg.mode in (Mode.NEW, Mode.CONTINUE):
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        if cfg.mode == Mode.CONTINUE and cfg.experiment is not None:
            cfg.experiment = cfg.experiment + "_" + stamp
        else:
            cfg.experiment = stamp
            if cfg.identifier is not None:
                cfg.experiment += "_" + cfg.identifier
        cfg.output_dir = osp.join(cfg.base_dir, cfg.experiment)
    else:
        cfg.output_dir = None

    cfg.git_commit = _git_commit()

    if cfg.mode in (Mode.NEW, Mode.CONTINUE):
        if cfg.optimizer.max_epochs is None and cfg.optimizer.max_iterations is None:
            raise RuntimeError(
                "Please define either max_epochs or max_iterations for the optimizer."
            )
        if cfg.scheduler.on_iteration and cfg.scheduler.on_validation:
            raise RuntimeError(
                "Schedulers can either be executed on epoch, on iteration or on validation."
            )

    cfg.scheduler.on_epoch = (
        not cfg.scheduler.on_iteration and not cfg.scheduler.on_validation
    )

    if not isinstance(cfg.metrics.loss, list) or not isinstance(cfg.metrics.other, list):
        raise RuntimeError(
            "Loss and other metrics have to be lists of metric configurations."
        )
    for entry in cfg.metrics.loss:
        entry["type"] = MetricType.create(entry["type"])
        entry.setdefault("weights", [1.0])
    for entry in cfg.metrics.other:
        entry["type"] = MetricType.create(entry["type"])

    cfg.model.label_type = LabelType.create(cfg.model.label_type)
    cfg.model.model_type = ModelType.create(cfg.model.model_type)
    if cfg.mode != Mode.INFERENCE and cfg.data.dataset_type is not None:
        cfg.data.dataset_type = DatasetType.create(cfg.data.dataset_type)

    if cfg.model.point_dim > cfg.model.input_dim:
        raise RuntimeError(
            "Model input dimension must be equal or smaller than point dimension."
        )

    cfg.freeze()


def load_config(cfg_filename: str, mode: Mode,
                ckpt_filename: Optional[str] = None) -> Config:
    """Read, finalize and validate a training/inference configuration."""
    config = create_default_config(mode=mode)
    read_config(config, cfg_filename)
    if ckpt_filename is not None:
        config.checkpoint = ckpt_filename
    finish_config(config)
    if not config.is_valid():
        raise RuntimeError(
            "Configuration is not valid, missing required parameters: "
            + ", ".join(config.missing_params())
        )
    return config


def load_model_config(cfg_filename: str, weights_filename: str) -> Config:
    """Load a model-only config (``model_config.yaml`` of a model directory)."""
    config = create_default_config(mode=Mode.INFERENCE)
    config.model.read_file(cfg_filename)
    config.model.weights = weights_filename
    finish_config(config)
    return config.model
