from .checkpoints import CheckpointManager
from .config import (
    DataConfig,
    ExperimentConfig,
    get_model,
    load_config,
    save_config,
)
from .convert import icon_state_dict_from_jax, state_dict_from_jax, vgg_params_from_jax
from .import_reference import load_reference_checkpoint, reference_state_dict
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
    "icon_state_dict_from_jax",
    "load_config",
    "load_reference_checkpoint",
    "reference_state_dict",
    "save_config",
    "state_dict_from_jax",
    "trace",
    "vgg_params_from_jax",
]
