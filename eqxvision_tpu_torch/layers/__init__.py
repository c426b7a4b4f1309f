from .drop_path import DropPath
from .extensions_2d import LayerNorm2d, Linear2d
from .mlps import MlpProjection
from .patch_embed import PatchEmbed

__all__ = ["DropPath", "LayerNorm2d", "Linear2d", "MlpProjection", "PatchEmbed"]
