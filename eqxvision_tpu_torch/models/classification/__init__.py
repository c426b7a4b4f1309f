from .convnext import ConvNeXt, convnext_base, convnext_large, convnext_small, convnext_tiny
from .swin import SwinTransformer, swin_b, swin_s, swin_t, swin_v2_b, swin_v2_s, swin_v2_t
from .vit import VisionTransformer, vit_base, vit_small, vit_tiny

__all__ = [
    "ConvNeXt",
    "SwinTransformer",
    "VisionTransformer",
    "convnext_base",
    "convnext_large",
    "convnext_small",
    "convnext_tiny",
    "swin_b",
    "swin_s",
    "swin_t",
    "swin_v2_b",
    "swin_v2_s",
    "swin_v2_t",
    "vit_base",
    "vit_small",
    "vit_tiny",
]
