"""Transformer MLP projection (eqxvision_tpu/layers/mlps.py)."""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..nn.activations import Lambda, gelu
from ..nn.dropout import Dropout
from ..nn.linear import Linear


def mlp_forward(fc1: Linear, act: Callable, drop1: nn.Module, fc2: Linear, drop2: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``drop2(fc2(drop1(act(fc1(x)))))`` with the activation acting on fc1's
    f32 accumulator (``Linear.preactivation``) and rounded to x's type once
    after it, as the JAX ``MlpProjection`` does."""
    return drop2(fc2(drop1(act(fc1.preactivation(x)).to(x.dtype))))


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
        # ViT's blocks take this path only in training with dropout or drop
        # path; otherwise they run ops.fused_mlp_half, which rounds as
        # mlp_forward does.
        return mlp_forward(self.fc1, self.act, self.drop1, self.fc2, self.drop2, x)
