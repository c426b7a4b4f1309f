"""Ops with a hand-written CUDA kernel and their plain torch versions, and
the plain ops around them (the BatchNorm fold, window partitioning)."""
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

__all__ = [
    "attention",
    "attention_half_reference",
    "attention_reference",
    "attention_stage_reference",
    "fold_batchnorm",
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
    "layer_norm",
    "layer_norm_reference",
    "mlp_half_reference",
    "shifted_window_attention",
    "window_qkv_attention",
    "window_attention_half_reference",
    "window_partition",
    "window_qkv_attention_reference",
    "window_unpartition",
]
