"""Configuration trees and the schema of training / model configs."""
from .config import Config, ConfigParam
from .schema import (
    Mode,
    create_default_config,
    finish_config,
    load_config,
    load_model_config,
    read_config,
)

__all__ = [
    "Config",
    "ConfigParam",
    "Mode",
    "create_default_config",
    "finish_config",
    "load_config",
    "load_model_config",
    "read_config",
]
