"""Model training from a YAML configuration.

    python -m deepclr_tpu_torch.training CONFIG.yaml [--ckpt CKPT]

Without ``--ckpt`` a new experiment starts (``Mode.NEW``); with it the run
continues from that full checkpoint into a new experiment directory
(``Mode.CONTINUE``).  The YAML's ``device`` decides where it runs: ``tpu``
and ``cuda`` mean the CUDA card (raising without one), ``cpu`` the CPU.
The run directory (``base_dir``/<stamp>_<identifier>) receives the config,
the model config and code, checkpoints with ``ckpt.pt`` / ``weights.pt``
links, a log file and the summaries, and is a model directory for
``python -m deepclr_tpu_torch.inference``.

SIGINT stops the run with an interrupt checkpoint and exit status 0; once
the state is persisted, further SIGINTs are ignored.  SIGUSR1 dumps every
thread's stack to stderr without stopping the run.

Data-parallel training runs one process per device, each with the same
arguments; ``batch_size`` is then per process and the global batch is
``batch_size`` × the process count.  With torchrun:

    DEEPCLR_DISTRIBUTED=1 torchrun --nproc_per_node=N -m deepclr_tpu_torch.training CONFIG.yaml

or one process a rank with the JAX package's contract:

    DEEPCLR_COORDINATOR=host:port DEEPCLR_NUM_PROCESSES=N DEEPCLR_PROCESS_ID=r \
        [DEEPCLR_LOCAL_DEVICE_IDS=d] python -m deepclr_tpu_torch.training CONFIG.yaml

(``parallel/distributed.py`` has the whole contract.)  Only rank 0 writes
the run directory.  SIGINT to any one rank stops every rank after the same
iteration (the ranks agree on it at the end of each iteration), and rank 0
writes the interrupt checkpoint with the global batch's gradient.
"""
from __future__ import annotations

import argparse
import faulthandler
import signal
import sys

from .config import Mode, load_config
from .engine import install_sigint_handler, train
from .parallel import maybe_initialize, shutdown

__all__ = ["main"]


def main(argv=None) -> None:
    # `kill -USR1 <pid>` shows where a stalled run waits
    faulthandler.register(signal.SIGUSR1, file=sys.__stderr__, all_threads=True)
    # one shutdown-aware SIGINT handler, installed before any work and never
    # displaced: it raises KeyboardInterrupt while the run is live and turns
    # into a log line once the resumable state is persisted
    install_sigint_handler()
    # data parallel: join the process group when the environment asks for
    # it (DEEPCLR_COORDINATOR / DEEPCLR_DISTRIBUTED); one process pays nothing
    maybe_initialize()
    try:
        parser = argparse.ArgumentParser(description="Model training.")
        parser.add_argument("config", type=str, help="training configuration (*.yaml)")
        parser.add_argument("--ckpt", type=str, default=None, help="checkpoint for continuing training")
        args = parser.parse_args(argv)

        mode = Mode.NEW if args.ckpt is None else Mode.CONTINUE
        cfg = load_config(args.config, mode, ckpt_filename=args.ckpt)
        train(cfg)
    finally:
        shutdown()


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        print("Interrupted by user")
    finally:
        # the trainer has persisted a resumable checkpoint and absorbs SIGINT
        # once shutdown starts; a signal during teardown or interpreter exit
        # must not flip the exit status either
        signal.signal(signal.SIGINT, signal.SIG_IGN)
