from .from_jax import load_jax_params, state_dict_from_jax
from .serialize import join_shards, load_model, save_model

__all__ = ["join_shards", "load_jax_params", "load_model", "save_model", "state_dict_from_jax"]
