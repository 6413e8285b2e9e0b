"""Data-parallel runtime: one process per device, joined by torch.distributed.

The JAX package joins its hosts into one ``jax.distributed`` runtime; this
package runs one process per CUDA device (or per CPU worker) and joins them
into one process group.  ``python -m deepclr_tpu_torch.training`` calls
``maybe_initialize()`` first; the trainer then shards its data loaders
(``shard_index=process_index(), num_shards=process_count()``), wraps the
model in DistributedDataParallel and writes checkpoints, logs and
summaries only where ``is_primary()``.  The environment contract is the
JAX package's:

- ``DEEPCLR_COORDINATOR`` (host:port), ``DEEPCLR_NUM_PROCESSES`` and
  ``DEEPCLR_PROCESS_ID``: ``init_process_group(init_method="tcp://host:port",
  world_size, rank)``; rank 0 listens on that port.  ``DEEPCLR_LOCAL_DEVICE_IDS``
  (comma-separated; the first is used) names the rank's CUDA device,
  else it is the process id modulo the device count;
- ``DEEPCLR_DISTRIBUTED=1``: ``init_method="env://"``, the variables that
  ``torchrun`` sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), with
  ``LOCAL_RANK`` naming the CUDA device.

The backend is NCCL when a card is present and gloo otherwise; a caller
that needs another one (two ranks sharing one card need gloo) calls
``initialize(..., backend=)`` itself, after which ``maybe_initialize``
has nothing to do.

A single process (neither variable set, or one process) initialises
nothing and pays nothing.  A failed initialisation raises; it never
carries on as one process.  Every collective waits at most ``TIMEOUT``, so a
rank left waiting for one that stopped fails instead of hanging.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["TIMEOUT", "initialize", "initialized", "is_primary", "local_device", "maybe_initialize",
           "process_count", "process_index", "shutdown"]

TIMEOUT = timedelta(minutes=10)


def initialized() -> bool:
    """Whether this process belongs to a process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, local_device_ids: Optional[Sequence[int]] = None,
               backend: Optional[str] = None) -> None:
    """Join the process group: over ``tcp://coordinator_address`` with
    ``num_processes`` and ``process_id``, or, without an address, from the
    ``env://`` variables.  One process (``num_processes`` <= 1) or a
    process already in a group: nothing to do.  With a card, the rank's
    CUDA device becomes the current one first."""
    if num_processes is not None and num_processes <= 1:
        return
    if initialized():
        return
    if coordinator_address:
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    else:
        init_method = "env://"
        world, rank = -1, -1  # read from WORLD_SIZE and RANK
    if torch.cuda.is_available():
        if local_device_ids:
            index = int(local_device_ids[0])
        elif "LOCAL_RANK" in os.environ:
            index = int(os.environ["LOCAL_RANK"])
        else:
            index = int(process_id if process_id is not None else os.environ.get("RANK", 0)) \
                % torch.cuda.device_count()
        torch.cuda.set_device(index)
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, timeout=TIMEOUT)


def maybe_initialize() -> bool:
    """Join the process group when the environment asks for it (the module
    docstring's contract).  Returns True when more than one process runs."""
    coord = os.environ.get("DEEPCLR_COORDINATOR")
    if coord:
        nproc = int(os.environ["DEEPCLR_NUM_PROCESSES"])
        local = os.environ.get("DEEPCLR_LOCAL_DEVICE_IDS")
        initialize(coord, nproc, int(os.environ["DEEPCLR_PROCESS_ID"]),
                   [int(x) for x in local.split(",")] if local else None)
        return nproc > 1
    if os.environ.get("DEEPCLR_DISTRIBUTED") == "1":
        world = os.environ.get("WORLD_SIZE")  # absent: env:// initialisation raises
        initialize(num_processes=int(world) if world else None)
    return process_count() > 1


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def is_primary() -> bool:
    """Rank 0: the one process that writes checkpoints, logs and summaries."""
    return process_index() == 0


def local_device() -> torch.device:
    """This process's device: its current CUDA device when a card is
    present (``initialize`` sets it), else the CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
