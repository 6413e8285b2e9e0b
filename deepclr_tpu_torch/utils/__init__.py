"""Host-side helpers: path expansion, logging and the summary writer."""
from .logging import SummaryWriter, create_logger, create_summary_writer
from .path import expand_path

__all__ = ["SummaryWriter", "create_logger", "create_summary_writer", "expand_path"]
