"""Host-side helpers: path expansion and logging."""
from .logging import create_logger
from .path import expand_path

__all__ = ["create_logger", "expand_path"]
