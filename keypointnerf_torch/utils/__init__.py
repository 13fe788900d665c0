from .config import (
    DataConfig,
    ExperimentConfig,
    get_model,
    load_config,
    save_config,
)
from .convert import state_dict_from_jax, vgg_params_from_jax

__all__ = [
    "DataConfig",
    "ExperimentConfig",
    "get_model",
    "load_config",
    "save_config",
    "state_dict_from_jax",
    "vgg_params_from_jax",
]
