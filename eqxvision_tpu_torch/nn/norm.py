"""Last-axis LayerNorm (eqxvision_tpu/nn/norm.py).

The forward is ``ops.layer_norm``, as the JAX layer's is: the mean and the
centred variance in f32, the affine parameters read in their stored type
and applied in f32, and one rounding to the input's type at the end. On a
CUDA tensor that is the hand-written kernel (``csrc/layer_norm.cu``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.layernorm import layer_norm


class LayerNorm(nn.Module):
    def __init__(
        self, dim: int, eps: float = 1e-5, elementwise_affine: bool = True, *, device: Optional[torch.device] = None
    ):
        super().__init__()
        self.dim = int(dim)
        self.eps = float(eps)
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(self.dim, device=device))
            self.bias = nn.Parameter(torch.zeros(self.dim, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)
