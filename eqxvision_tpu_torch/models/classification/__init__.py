from .vit import VisionTransformer, vit_base, vit_small, vit_tiny

__all__ = ["VisionTransformer", "vit_base", "vit_small", "vit_tiny"]
