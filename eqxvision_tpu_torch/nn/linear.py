"""Dense layer (eqxvision_tpu/nn/linear.py) in torch's own layout.

The weight is stored (out_features, in_features), as torch stores it; the
JAX package stores (in, out), and ``weights.from_jax`` transposes. Parameters
keep their dtype and the weight is cast to the input's at use, as in the JAX
layer. Torch's matmuls accumulate bf16 products in f32. The bias is added,
in its stored type, to the f32 accumulator, which is then rounded once: one
call where the bias has the input's type, else ``preactivation`` (f32
parameters and a bf16 input, the JAX package's mixed path).
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
        return linear(x, self.weight, self.bias)

    def preactivation(self, x: torch.Tensor) -> torch.Tensor:
        """The product accumulated in f32 (or x's type where that is wider)
        plus the bias in that type, before the cast to x's type: the JAX
        layer's ``Linear.preactivation``. An activation applied to it acts on
        the accumulator, not on a rounded output."""
        return preactivation(x, self.weight, self.bias)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``Linear``'s forward on these parameters."""
    if bias is None or bias.dtype == x.dtype:
        return F.linear(x, weight.to(x.dtype), bias)
    return preactivation(x, weight, bias).to(x.dtype)


def preactivation(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``Linear.preactivation`` on these parameters."""
    y = wide_product(x, weight.to(x.dtype))
    return y if bias is None else y + bias.to(y.dtype)


def wide_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` (w in the (out, in) layout, of x's type) accumulated in
    f32, or in x's type where that is wider, and returned unrounded. On the
    card, where no gradient is taken, a bf16 product keeps the GEMM's f32
    accumulator (``torch.mm``'s ``out_dtype``, which has no derivative;
    ``torch.addmm``'s expands the bias over the output first, which is
    slower). Otherwise the operands are upcast: exact, since f32 (and TF32)
    holds every bf16 value, and differentiable."""
    wide = torch.promote_types(x.dtype, torch.float32)
    needs_grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if x.dtype == wide:
        return F.linear(x, w)
    if x.device.type == "cuda" and not needs_grad:
        return torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=wide).reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x.to(wide), w.to(wide))
