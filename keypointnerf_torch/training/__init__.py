from .draws import QueryDraws, TrainDraws
from .losses import LossConfig, compute_losses, pix_loss
from .train import (
    OptimConfig,
    TrainState,
    apply_gradients,
    clip_by_global_norm,
    create_train_state,
    eval_step_fn,
    global_norm,
    make_lr,
    make_optimizer,
    train_step_fn,
)

__all__ = [
    "QueryDraws",
    "TrainDraws",
    "LossConfig",
    "compute_losses",
    "pix_loss",
    "OptimConfig",
    "TrainState",
    "clip_by_global_norm",
    "create_train_state",
    "eval_step_fn",
    "global_norm",
    "make_lr",
    "make_optimizer",
    "train_step_fn",
    "apply_gradients",
]
