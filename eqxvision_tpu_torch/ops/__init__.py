"""Ops with a hand-written CUDA kernel and their plain torch versions, and
the plain ops around them (the BatchNorm and LayerNorm folds, the
space-to-depth stem, window partitioning, the
preprocessing and the training augmentations)."""
from .attention import (
    attention,
    attention_reference,
    attention_stage_reference,
    fused_qkv_attention,
    fused_qkv_attention_reference,
    window_qkv_attention,
    window_qkv_attention_reference,
)
from .attention_half import attention_half_reference, fused_attention_half
from .fold_bn import fold_batchnorm
from .fold_ln import fold_layernorm
from .layernorm import layer_norm, layer_norm_reference
from .mlp_half import fused_mlp_half, mlp_half_reference
from .window_attention import (
    fused_swin_block,
    fused_swin_block_reference,
    fused_swin_block_supported,
    fused_swin_block_v1,
    fused_swin_block_v2,
    shifted_window_attention,
    window_partition,
    window_unpartition,
)
from .window_attention_half import fused_window_attention_half, window_attention_half_reference
from .preprocessing import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    center_crop,
    five_crop,
    imagenet_eval_pipeline,
    normalize,
    resize_shorter_side,
    ten_crop,
)
from .augment import (
    adjust_brightness,
    adjust_contrast,
    adjust_hue,
    adjust_saturation,
    color_jitter,
    cutmix,
    imagenet_train_pipeline,
    mixup,
    random_erasing,
    random_hflip,
    random_resized_crop,
    random_vflip,
    smooth_labels,
)

__all__ = [
    "adjust_brightness",
    "adjust_contrast",
    "adjust_hue",
    "adjust_saturation",
    "attention",
    "attention_half_reference",
    "attention_reference",
    "attention_stage_reference",
    "center_crop",
    "color_jitter",
    "cutmix",
    "five_crop",
    "fold_batchnorm",
    "fold_layernorm",
    "fused_attention_half",
    "fused_mlp_half",
    "fused_qkv_attention",
    "fused_qkv_attention_reference",
    "fused_swin_block",
    "fused_swin_block_reference",
    "fused_swin_block_supported",
    "fused_swin_block_v1",
    "fused_swin_block_v2",
    "fused_window_attention_half",
    "imagenet_eval_pipeline",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "imagenet_train_pipeline",
    "layer_norm",
    "layer_norm_reference",
    "mixup",
    "mlp_half_reference",
    "normalize",
    "random_erasing",
    "random_hflip",
    "random_resized_crop",
    "random_vflip",
    "resize_shorter_side",
    "shifted_window_attention",
    "smooth_labels",
    "ten_crop",
    "window_attention_half_reference",
    "window_partition",
    "window_qkv_attention",
    "window_qkv_attention_reference",
    "window_unpartition",
]
