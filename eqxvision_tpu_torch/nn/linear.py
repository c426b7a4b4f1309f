"""Dense layer (eqxvision_tpu/nn/linear.py) in torch's own layout.

The weight is stored (out_features, in_features), as torch stores it; the
JAX package stores (in, out), and ``weights.from_jax`` transposes. Parameters
keep their dtype and are cast to the input's at use, as in the JAX layer.
Torch's matmuls accumulate bf16 products in f32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core import init


class Linear(nn.Module):
    def __init__(
        self, in_features: int, out_features: int, use_bias: bool = True, *,
        generator: torch.Generator, device: Optional[torch.device] = None,
    ):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        kw = dict(generator=generator, device=device)
        self.weight = nn.Parameter(init.kaiming_uniform((out_features, in_features), in_features, **kw))
        self.bias = nn.Parameter(init.uniform_fan_in((out_features,), in_features, **kw)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)
