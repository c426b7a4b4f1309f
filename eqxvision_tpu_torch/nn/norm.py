"""Last-axis LayerNorm (eqxvision_tpu/nn/norm.py).

Mean and variance are taken in f32, as in the JAX layer: torch's layer_norm
accumulates in f32 for a bf16 input. The affine parameters are cast to the
input's dtype at use.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, *, device: Optional[torch.device] = None):
        super().__init__()
        self.dim = int(dim)
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(self.dim, device=device))
        self.bias = nn.Parameter(torch.zeros(self.dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (self.dim,), self.weight.to(x.dtype), self.bias.to(x.dtype), self.eps)
