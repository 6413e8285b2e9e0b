"""Data-parallel helpers over the process group: host gathers, averages
over processes, and the model's data-parallel wrapper.

The JAX package shards the global batch over a 1-D ``dp`` device mesh and
replicates the parameters; XLA inserts the gradient all-reduce.  Here each
process owns one device and its own shard of the batch, so the JAX
functions map as follows:

- ``make_mesh`` / ``make_mesh_for_batch`` + ``put_replicated``:
  ``wrap_data_parallel`` (DistributedDataParallel: parameters broadcast
  from rank 0 once, gradients averaged over the processes every update);
- ``shard_batch``: nothing; each process moves its own loader shard;
- ``allgather_host``, ``allgather_host_f64``, ``allgather_host_strings``:
  the same names and contract, in process-index order, the identity in a
  single process;
- the replicated metric means of JAX's eval step: ``mean_over_processes``;
- the batch norms and dropout of a step over the global array:
  ``set_process_group`` (``wrap_data_parallel`` calls it).

Rank r's rows are rows [r·B, (r+1)·B) of the global batch, JAX's
process-major order.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from ..models.deepclr import OutputSimple
from ..models.layers import BatchNorm
from .distributed import initialized, process_count

__all__ = ["allgather_host", "allgather_host_f64", "allgather_host_strings", "mean_over_processes",
           "set_process_group", "wrap_data_parallel"]


def _allgather_objects(obj) -> List:
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def allgather_host(values: np.ndarray) -> np.ndarray:
    """Concatenate every process's host array along the first axis, in
    process-index order.  Single process: the array itself."""
    values = np.asarray(values)
    if process_count() == 1:
        return values
    return np.concatenate(_allgather_objects(values), axis=0).reshape((-1,) + values.shape[1:])


def allgather_host_f64(values: np.ndarray) -> np.ndarray:
    """``allgather_host`` of float64 values, bit for bit (the JAX package
    splits them into uint32 halves for its device collective; the gather
    here carries the array as it is)."""
    return allgather_host(np.ascontiguousarray(np.asarray(values, dtype=np.float64)))


def allgather_host_strings(names: Sequence, width: int = 96) -> list:
    """Gather every process's list of strings, in process-index order.
    Across processes a name keeps its first ``width`` UTF-8 bytes, NUL
    bytes dropped and broken characters replaced, as in the JAX package's
    fixed-width transport; a single process returns ``str`` of each name."""
    if process_count() == 1:
        return [str(n) for n in names]
    enc = [str(n).encode("utf-8")[:width] for n in names]
    return [b.replace(b"\x00", b"").decode("utf-8", errors="replace")
            for part in _allgather_objects(enc) for b in part]


def mean_over_processes(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the processes (a sum all-reduce over the
    count); ``t`` itself without a process group.  A CPU tensor travels
    through the current CUDA device when the backend is NCCL."""
    if not initialized():
        return t
    nccl = dist.get_backend() == dist.Backend.NCCL
    x = t.to(torch.device("cuda", torch.cuda.current_device())) if nccl and t.device.type == "cpu" else t.clone()
    dist.all_reduce(x)
    return (x / process_count()).to(t.device)


def set_process_group(model: nn.Module, group) -> None:
    """Give every ``BatchNorm`` and ``OutputSimple`` of ``model`` the process
    group over which its training forwards compute batch statistics and
    draw dropout masks (as ``SyncBatchNorm.convert_sync_batchnorm`` does);
    None takes them back to this process's rows alone."""
    for m in model.modules():
        if isinstance(m, (BatchNorm, OutputSimple)):
            m.process_group = group


def wrap_data_parallel(model: nn.Module) -> DistributedDataParallel:
    """DistributedDataParallel over the default process group, on the
    device the model's parameters are on (``device_ids`` on a card, none
    on the CPU), with the model's batch norms and dropout set to the
    global batch (``set_process_group``; the caller sets them back to None
    when it stops training data-parallel).  Buffers are not broadcast: the
    batch norms' running statistics come from the global batch's
    statistics and so are the same on every rank.  Every parameter must get
    a gradient in every backward (``find_unused_parameters`` is off)."""
    set_process_group(model, dist.group.WORLD)
    dev = next(model.parameters()).device
    return DistributedDataParallel(model, device_ids=[dev.index] if dev.type == "cuda" else None,
                                   broadcast_buffers=False)
