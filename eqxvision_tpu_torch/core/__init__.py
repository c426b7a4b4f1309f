"""Initialisation. The JAX package's module system, state, filters and
precision scopes have no counterpart here: ``nn.Module``, buffers and
torch's f32-accumulating matmuls already do their job."""
from . import init

__all__ = ["init"]
