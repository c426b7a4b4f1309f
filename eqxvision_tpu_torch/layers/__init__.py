from .drop_path import DropPath
from .mlps import MlpProjection
from .patch_embed import PatchEmbed

__all__ = ["DropPath", "MlpProjection", "PatchEmbed"]
