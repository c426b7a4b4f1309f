"""Activations and the Lambda wrapper (eqxvision_tpu/nn/activations.py)."""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

Identity = nn.Identity


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, 0.5 x (1 + erf(x / sqrt(2))), which the JAX package
    writes out by hand. ``F.gelu``'s default is this form, and for a bf16
    input it computes in f32 and rounds once."""
    return F.gelu(x)


class Lambda(nn.Module):
    """Wrap a plain function as a layer; it holds no parameters."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)
