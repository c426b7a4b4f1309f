"""Squeeze-and-excitation on NHWC tensors (eqxvision_tpu/layers/squeeze.py).

The mean over H and W, a 1x1 squeeze convolution, ``activation``, a 1x1
excitation convolution, ``scale_activation``, and the channel scale of x.
``fc1`` and ``fc2`` are ``Conv2d``s with a bias, as torchvision's, so its
weights load by name. The mean of a bf16 map accumulates in f32 and rounds
once, as ``jnp.mean`` does.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..nn.activations import Lambda, relu, sigmoid
from ..nn.conv import Conv2d


class SqueezeExcitation(nn.Module):
    def __init__(
        self,
        input_channels: int,
        squeeze_channels: int,
        activation: Callable = relu,
        scale_activation: Callable = sigmoid,
        *,
        generator: torch.Generator,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.fc1 = Conv2d(input_channels, squeeze_channels, 1, **kw)
        self.fc2 = Conv2d(squeeze_channels, input_channels, 1, **kw)
        self.activation = Lambda(activation)
        self.scale_activation = Lambda(scale_activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((1, 2), keepdim=True)
        s = self.scale_activation(self.fc2(self.activation(self.fc1(s))))
        return x * s
