import importlib

from .profiling import StepTimer, check_finite, enable_nan_checks, span, trace

# the rest is imported on first use: the models, the renderer, the training
# step and the kernels' wrappers import `span` from this package, and
# utils/config.py imports them back
_LAZY = {
    "CheckpointManager": "checkpoints",
    "DataConfig": "config",
    "ExperimentConfig": "config",
    "get_model": "config",
    "load_config": "config",
    "save_config": "config",
    "icon_state_dict_from_jax": "convert",
    "state_dict_from_jax": "convert",
    "vgg_params_from_jax": "convert",
    "load_reference_checkpoint": "import_reference",
    "reference_state_dict": "import_reference",
    "MetricsWriter": "metrics_writer",
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CheckpointManager",
    "DataConfig",
    "ExperimentConfig",
    "MetricsWriter",
    "StepTimer",
    "check_finite",
    "enable_nan_checks",
    "get_model",
    "icon_state_dict_from_jax",
    "load_config",
    "load_reference_checkpoint",
    "reference_state_dict",
    "save_config",
    "span",
    "state_dict_from_jax",
    "trace",
    "vgg_params_from_jax",
]
