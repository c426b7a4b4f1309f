"""Activations and the Lambda wrapper (eqxvision_tpu/nn/activations.py).

Each activation is one torch op. For a bf16 input torch computes it in f32
and rounds once, where the JAX functions round after every elementwise
step (``hard_swish`` is x * relu6(x + 3) * (1/6), three roundings). In f32
the two agree to about 1e-6; in bf16 ``hard_swish`` and ``silu`` differ on
about a third of outputs by at most two bf16 steps, ``hard_sigmoid`` on a
fifth by at most one, and ``relu6`` on none (ROADMAP C.13;
``tests/test_torch_mobile_layers.py`` pins the bounds).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

Identity = nn.Identity
relu = torch.relu
sigmoid = torch.sigmoid
tanh = torch.tanh


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, 0.5 x (1 + erf(x / sqrt(2))), which the JAX package
    writes out by hand. ``F.gelu``'s default is this form, and for a bf16
    input it computes in f32 and rounds once."""
    return F.gelu(x)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x): torch.nn.SiLU."""
    return F.silu(x)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """relu6(x + 3) / 6: torch.nn.Hardsigmoid."""
    return F.hardsigmoid(x)


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    """x * relu6(x + 3) / 6: torch.nn.Hardswish."""
    return F.hardswish(x)


class Lambda(nn.Module):
    """Wrap a plain function as a layer; it holds no parameters."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)
