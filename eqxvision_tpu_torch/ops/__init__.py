"""Ops with a hand-written CUDA kernel and their plain torch versions."""
from .attention import fused_qkv_attention, fused_qkv_attention_reference

__all__ = ["fused_qkv_attention", "fused_qkv_attention_reference"]
