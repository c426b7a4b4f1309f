from .from_jax import load_jax_params, state_dict_from_jax

__all__ = ["load_jax_params", "state_dict_from_jax"]
