"""Parameter initializers on an explicit ``torch.Generator``.

Counterpart of eqxvision_tpu/core/init.py: the same distributions (torch's
layer defaults, timm's truncated normal), but not the same numbers, since
``jax.random`` and ``torch.Generator`` are different streams. Weights move
between the two packages with ``weights.from_jax``.

Values are drawn in f32 on the generator's device and then moved to
``device``, so one seed gives the same weights on every device. On the
``meta`` device nothing is drawn or allocated.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch


def _target(generator: Optional[torch.Generator], device) -> torch.device:
    if device is not None:
        return torch.device(device)
    return torch.device("cpu") if generator is None else generator.device


def _drawn(shape: Sequence[int], generator: torch.Generator, device, fill: Callable) -> torch.Tensor:
    target = _target(generator, device)
    if target.type == "meta":
        return torch.empty(tuple(shape), device=target)
    t = torch.empty(tuple(shape), device=generator.device)
    fill(t)
    return t.to(target)


def kaiming_uniform(
    shape: Sequence[int], fan_in: int, *, generator: torch.Generator, device: Optional[torch.device] = None
) -> torch.Tensor:
    """torch.nn.init.kaiming_uniform_(a=sqrt(5)), the Conv2d/Linear weight
    default: U(-b, b) with b = sqrt(6 / ((1 + a^2) * fan_in))."""
    a = math.sqrt(5.0)
    bound = math.sqrt(6.0 / ((1.0 + a * a) * fan_in))
    return _drawn(shape, generator, device, lambda t: t.uniform_(-bound, bound, generator=generator))


def uniform_fan_in(
    shape: Sequence[int], fan_in: int, *, generator: torch.Generator, device: Optional[torch.device] = None
) -> torch.Tensor:
    """torch's bias default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return _drawn(shape, generator, device, lambda t: t.uniform_(-bound, bound, generator=generator))


def trunc_normal(
    shape: Sequence[int], *, generator: torch.Generator, std: float = 0.02, device: Optional[torch.device] = None
) -> torch.Tensor:
    """Normal truncated to [-2, 2] standard deviations, times ``std``
    (timm-style; std 0.02 for ViT's cls token and position embedding)."""

    def fill(t):
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator).mul_(std)

    return _drawn(shape, generator, device, fill)


def kaiming_normal(
    shape: Sequence[int], fan: int, *, generator: torch.Generator, nonlinearity: str = "relu",
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """N(0, std^2) with std = gain / sqrt(fan), gain sqrt(2) for ReLU and 1
    otherwise (torch.nn.init.kaiming_normal_'s fan-out use in the conv
    nets)."""
    std = (math.sqrt(2.0) if nonlinearity == "relu" else 1.0) / math.sqrt(fan)
    return _drawn(shape, generator, device, lambda t: t.normal_(0.0, std, generator=generator))


def normal(
    shape: Sequence[int], *, generator: torch.Generator, std: float = 0.01, device: Optional[torch.device] = None
) -> torch.Tensor:
    """N(0, std^2) (std 0.01: torchvision's classifier heads)."""
    return _drawn(shape, generator, device, lambda t: t.normal_(0.0, std, generator=generator))


def zeros(shape: Sequence[int], dtype: torch.dtype = torch.float32, *, generator: Optional[torch.Generator] = None,
          device: Optional[torch.device] = None) -> torch.Tensor:
    """Zeros on ``device`` (else the generator's, else the CPU); the
    generator, taken for a uniform signature, draws nothing."""
    return torch.zeros(tuple(shape), dtype=dtype, device=_target(generator, device))


def ones(shape: Sequence[int], dtype: torch.dtype = torch.float32, *, generator: Optional[torch.Generator] = None,
         device: Optional[torch.device] = None) -> torch.Tensor:
    """Ones, as ``zeros``."""
    return torch.ones(tuple(shape), dtype=dtype, device=_target(generator, device))
