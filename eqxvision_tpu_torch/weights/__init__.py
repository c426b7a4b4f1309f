from .from_jax import load_jax_params, state_dict_from_jax
from .serialize import join_shards, load_model, save_model
from .torch_import import load_torch_state_dict, load_torch_weights, resolve_torch_checkpoint
from .urls import CLASSIFICATION_URLS, SEGMENTATION_URLS

__all__ = ["CLASSIFICATION_URLS", "SEGMENTATION_URLS", "join_shards", "load_jax_params", "load_model",
           "load_torch_state_dict", "load_torch_weights", "resolve_torch_checkpoint", "save_model",
           "state_dict_from_jax"]
