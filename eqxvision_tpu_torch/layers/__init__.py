from .conv_norm_activation import ConvNormActivation
from .drop_path import DropPath
from .extensions_2d import LayerNorm2d, Linear2d
from .mlps import MlpProjection
from .patch_embed import PatchEmbed
from .squeeze import SqueezeExcitation

__all__ = ["ConvNormActivation", "DropPath", "LayerNorm2d", "Linear2d", "MlpProjection", "PatchEmbed",
           "SqueezeExcitation"]
