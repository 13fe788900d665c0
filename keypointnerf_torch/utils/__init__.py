from .convert import state_dict_from_jax, vgg_params_from_jax

__all__ = ["state_dict_from_jax", "vgg_params_from_jax"]
