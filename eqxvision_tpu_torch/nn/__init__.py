"""Layers the ported models need, with torch's parameter names and layouts."""
from .activations import Identity, Lambda, gelu, hard_sigmoid, hard_swish, relu, relu6, sigmoid, silu, tanh
from .conv import Conv2d
from .dropout import Dropout
from .flatten import FlattenCHW, flatten_chw
from .linear import Linear
from .norm import BatchNorm, GroupNorm, LayerNorm
from .pool import AdaptiveAvgPool2d, AdaptiveMaxPool2d, AvgPool2d, MaxPool2d, adaptive_avg_pool2d

__all__ = [
    "AdaptiveAvgPool2d",
    "AdaptiveMaxPool2d",
    "AvgPool2d",
    "BatchNorm",
    "Conv2d",
    "Dropout",
    "FlattenCHW",
    "GroupNorm",
    "Identity",
    "Lambda",
    "LayerNorm",
    "Linear",
    "MaxPool2d",
    "adaptive_avg_pool2d",
    "flatten_chw",
    "gelu",
    "hard_sigmoid",
    "hard_swish",
    "relu",
    "relu6",
    "sigmoid",
    "silu",
    "tanh",
]
