from .checkpoints import CheckpointManager
from .config import (
    DataConfig,
    ExperimentConfig,
    get_model,
    load_config,
    save_config,
)
from .convert import state_dict_from_jax, vgg_params_from_jax
from .metrics_writer import MetricsWriter
from .profiling import StepTimer, annotate, check_finite, enable_nan_checks, trace

__all__ = [
    "CheckpointManager",
    "DataConfig",
    "ExperimentConfig",
    "MetricsWriter",
    "StepTimer",
    "annotate",
    "check_finite",
    "enable_nan_checks",
    "get_model",
    "load_config",
    "save_config",
    "state_dict_from_jax",
    "trace",
    "vgg_params_from_jax",
]
