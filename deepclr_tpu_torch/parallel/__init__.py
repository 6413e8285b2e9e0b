"""Data-parallel training on torch.distributed: the process group and the
helpers over it (the JAX package's ``parallel``)."""
from .distributed import (initialize, initialized, is_primary, local_device, maybe_initialize, process_count,
                          process_index, shutdown)
from .mesh import (allgather_host, allgather_host_f64, allgather_host_strings, any_over_processes,
                   mean_over_processes, set_process_group, wrap_data_parallel)

__all__ = [
    "allgather_host",
    "allgather_host_f64",
    "allgather_host_strings",
    "any_over_processes",
    "initialize",
    "initialized",
    "is_primary",
    "local_device",
    "maybe_initialize",
    "mean_over_processes",
    "process_count",
    "process_index",
    "set_process_group",
    "shutdown",
    "wrap_data_parallel",
]
