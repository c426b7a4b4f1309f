"""Stochastic depth (eqxvision_tpu/layers/drop_path.py, ``mode="global"``).

One Bernoulli draw per sample, kept with probability 1 - p and scaled by
1 / (1 - p): torchvision's ``StochasticDepth(mode="row")``. A no-op at p=0
and in eval mode. The mask comes from torch's default generator of the
input's device. Every JAX model that drops paths, EfficientNet's stochastic
depth included, uses this mode; the JAX layer's per-channel mode has no user
and no counterpart here yet.
"""
from __future__ import annotations

import torch
from torch import nn


class DropPath(nn.Module):
    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.empty((x.shape[0],) + (1,) * (x.ndim - 1), device=x.device).bernoulli_(keep)
        return torch.where(mask.bool(), x / keep, torch.zeros_like(x))
