"""Transformer MLP projection (eqxvision_tpu/layers/mlps.py)."""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..nn.activations import Lambda, gelu
from ..nn.dropout import Dropout
from ..nn.linear import Linear


class MlpProjection(nn.Module):
    def __init__(
        self,
        in_features: int,
        hidden_features: Optional[int] = None,
        out_features: Optional[int] = None,
        act_layer: Callable = gelu,
        drop: float = 0.0,
        *,
        generator: torch.Generator,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        out_features = out_features or in_features
        hidden_features = hidden_features or in_features
        kw = dict(generator=generator, device=device)
        self.fc1 = Linear(in_features, hidden_features, **kw)
        self.act = Lambda(act_layer)
        self.drop1 = Dropout(drop)
        self.fc2 = Linear(hidden_features, out_features, **kw)
        self.drop2 = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The JAX layer applies the activation to fc1's f32 accumulator and
        # casts once (Linear.preactivation). torch's GEMM returns the input
        # dtype, so in bf16 this rounds fc1's output before gelu. ViT's
        # blocks take this path only in training with dropout or drop path;
        # otherwise they run ops.fused_mlp_half, which rounds once.
        x = self.drop1(self.act(self.fc1(x)))
        return self.drop2(self.fc2(x))
