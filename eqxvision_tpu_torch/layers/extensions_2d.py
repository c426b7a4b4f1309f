"""LayerNorm2d and Linear2d (eqxvision_tpu/layers/extensions_2d.py).

On NHWC maps a channelwise LayerNorm and a per-position Linear both act on
the last axis, which is what ``nn.LayerNorm`` and ``nn.Linear`` already do;
the subclasses keep the reference's vocabulary and give ConvNeXt's
classifier norm its own type.
"""
from __future__ import annotations

from ..nn.linear import Linear
from ..nn.norm import LayerNorm


class LayerNorm2d(LayerNorm):
    """Channelwise LayerNorm over NHWC maps: LayerNorm on axis -1."""


class Linear2d(Linear):
    """Per-position (1x1-conv-equivalent) Linear over NHWC maps."""
