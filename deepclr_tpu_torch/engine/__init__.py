"""Training engine: the train and eval steps, the training loop, training
from a configuration, and checkpoints."""
from .checkpoint import Checkpointer, load_checkpoint
from .trainer import (BATCH_KEYS, TrainState, create_train_state, install_sigint_handler, make_eval_step,
                      make_train_step, run_trainer, store_models_code, train)

__all__ = ["BATCH_KEYS", "Checkpointer", "TrainState", "create_train_state", "install_sigint_handler",
           "load_checkpoint", "make_eval_step", "make_train_step", "run_trainer", "store_models_code",
           "train"]
