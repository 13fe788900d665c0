from .draws import QueryDraws, TrainDraws, patch_pool
from .losses import LossConfig, compute_losses, pix_loss
from .train import (
    OptimConfig,
    TrainState,
    apply_gradients,
    clip_by_global_norm,
    create_train_state,
    eval_batch_step_fn,
    eval_step_fn,
    global_norm,
    make_lr,
    make_optimizer,
    step_generator,
    train_batch_step_fn,
    train_step_fn,
)

__all__ = [
    "QueryDraws",
    "TrainDraws",
    "patch_pool",
    "LossConfig",
    "compute_losses",
    "pix_loss",
    "OptimConfig",
    "TrainState",
    "clip_by_global_norm",
    "create_train_state",
    "eval_batch_step_fn",
    "eval_step_fn",
    "global_norm",
    "make_lr",
    "make_optimizer",
    "step_generator",
    "train_batch_step_fn",
    "train_step_fn",
    "apply_gradients",
]
