from .checkpoint import (
    load_params,
    load_train_state,
    save_params,
    save_train_state,
)
from .train import TrainState, loss_fn, make_optimizer, make_train_state, train_step

__all__ = [
    "load_params",
    "load_train_state",
    "save_params",
    "save_train_state",
    "TrainState",
    "loss_fn",
    "make_optimizer",
    "make_train_state",
    "train_step",
]
