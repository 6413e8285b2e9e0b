"""Host-side helpers: path expansion, logging and the summary writer, the
subclass factory and tensor transfer (``flops``, ``profiling``, ``parsing``
and ``pcv`` are imported as modules)."""
from .factory import factory
from .logging import SummaryWriter, create_logger, create_summary_writer
from .path import expand_path
from .tensor import prepare_tensor

__all__ = ["SummaryWriter", "create_logger", "create_summary_writer", "expand_path", "factory", "prepare_tensor"]
