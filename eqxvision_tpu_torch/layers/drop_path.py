"""Stochastic depth (eqxvision_tpu/layers/drop_path.py).

Kept with probability 1 - p and scaled by 1 / (1 - p), a no-op at p=0 and in
eval mode. ``mode="global"``: one Bernoulli draw per sample, a mask of shape
(N, 1, ..., 1), torchvision's ``StochasticDepth(mode="row")``, which every
model of the zoo uses, EfficientNet's stochastic depth included.
``mode="local"`` (or its alias ``"per_channel"``): one draw per (sample,
channel), a mask of shape (N, 1, ..., C) on channels-last input. The mask
comes from torch's default generator of the input's device.
"""
from __future__ import annotations

import torch
from torch import nn

_MODES = ("global", "local", "per_channel")


class DropPath(nn.Module):
    def __init__(self, p: float = 0.0, mode: str = "global"):
        super().__init__()
        if mode not in _MODES:
            raise ValueError(f"mode {mode!r}: not one of {_MODES}")
        self.p = float(p)
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        if self.mode == "global":
            shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        else:
            shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        mask = torch.empty(shape, device=x.device).bernoulli_(keep)
        return torch.where(mask.bool(), x / keep, torch.zeros_like(x))
