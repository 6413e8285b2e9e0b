"""Training engine: the train step, the training loop and checkpoints."""
from .checkpoint import Checkpointer, load_checkpoint
from .trainer import BATCH_KEYS, TrainState, create_train_state, install_sigint_handler, make_train_step, run_trainer

__all__ = ["BATCH_KEYS", "Checkpointer", "TrainState", "create_train_state", "install_sigint_handler",
           "load_checkpoint", "make_train_step", "run_trainer"]
