"""Training loops and data pipeline for the flow."""

from flowstate.training.data import (
    dedup_subsample,
    epoch_batches,
    flatten_configs,
    sliding_window_update,
)
from flowstate.training.blocked import (
    blocked_pairs,
    make_blocked_train_step,
    train_blocked,
)
from flowstate.training.train import (
    TrainConfig,
    TrainState,
    make_optimizer,
    make_train_step,
    train,
)

__all__ = [
    "TrainConfig", "TrainState", "make_optimizer", "make_train_step", "train",
    "flatten_configs", "dedup_subsample", "epoch_batches",
    "sliding_window_update",
    "blocked_pairs", "make_blocked_train_step", "train_blocked",
]
