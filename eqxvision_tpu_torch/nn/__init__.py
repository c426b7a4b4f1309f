"""Layers the ported models need, with torch's parameter names and layouts."""
from .activations import Identity, Lambda, gelu
from .conv import Conv2d
from .dropout import Dropout
from .linear import Linear
from .norm import LayerNorm

__all__ = ["Conv2d", "Dropout", "Identity", "Lambda", "LayerNorm", "Linear", "gelu"]
