"""Conv2d -> norm -> activation (eqxvision_tpu/layers/conv_norm_activation.py).

An ``nn.Sequential``, as torchvision's ``Conv2dNormActivation``, so the
state-dict names are torchvision's: the convolution at index 0, the norm at
1 (``features.0.1.running_mean``), the activation after them; without a
norm the activation moves up to index 1. Default padding ``(k - 1) // 2 *
dilation``; the convolution has a bias only where there is no norm.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..nn.activations import Lambda, relu
from ..nn.conv import Conv2d
from ..nn.norm import BatchNorm


class ConvNormActivation(nn.Sequential):
    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: Optional[int] = None,
        groups: int = 1,
        norm_layer: Optional[Callable[..., nn.Module]] = BatchNorm,
        activation_layer: Optional[Callable] = relu,
        dilation: int = 1,
        use_bias: Optional[bool] = None,
        *,
        generator: torch.Generator,
        device: Optional[torch.device] = None,
    ):
        if padding is None:
            padding = (kernel_size - 1) // 2 * dilation
        if use_bias is None:
            use_bias = norm_layer is None
        layers = [Conv2d(in_channels, out_channels, kernel_size, stride=stride, padding=padding, dilation=dilation,
                         groups=groups, use_bias=use_bias, generator=generator, device=device)]
        if norm_layer is not None:
            layers.append(norm_layer(out_channels, device=device))
        if activation_layer is not None:
            layers.append(activation_layer if isinstance(activation_layer, nn.Module) else Lambda(activation_layer))
        super().__init__(*layers)
        self.out_channels = out_channels
