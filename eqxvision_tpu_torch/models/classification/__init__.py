from .swin import SwinTransformer, swin_b, swin_s, swin_t, swin_v2_b, swin_v2_s, swin_v2_t
from .vit import VisionTransformer, vit_base, vit_small, vit_tiny

__all__ = [
    "SwinTransformer",
    "VisionTransformer",
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
