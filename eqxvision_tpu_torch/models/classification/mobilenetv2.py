"""MobileNetV2, NHWC batched (eqxvision_tpu/models/classification/mobilenetv2.py).

Inverted residuals with linear bottlenecks, channels scaled by
``width_mult`` through ``_make_divisible``. torchvision's names: ``features``
(the stem ``ConvNormActivation``, the blocks, the last 1x1
``ConvNormActivation``) and ``classifier`` (dropout, linear); a block's
``conv`` Sequential ends in a 1x1 ``Conv2d`` and a ``BatchNorm`` at its
last two indices (``features.1.conv.1``, ``features.1.conv.2`` where the
block does not expand). cuDNN convolutions, depthwise ones included, on the
channels-last view; no kernel of the port runs here.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Union

import torch
from torch import nn

from ... import nn as N
from ...layers import ConvNormActivation
from ...utils import _make_divisible
from .._common import debatch, default_generator, ensure_nhwc, maybe_load_state_dict, resolve_device


class _InvertedResidual(nn.Module):
    def __init__(self, inp, oup, stride, expand_ratio, norm_layer=N.BatchNorm, *, generator, device=None):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError(f"stride should be 1 or 2, got {stride}")
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res_connect = stride == 1 and inp == oup
        self.out_channels = oup
        kw = dict(norm_layer=norm_layer, activation_layer=N.relu6, generator=generator, device=device)
        layers = []
        if expand_ratio != 1:
            layers.append(ConvNormActivation(inp, hidden_dim, kernel_size=1, **kw))
        layers += [
            ConvNormActivation(hidden_dim, hidden_dim, stride=stride, groups=hidden_dim, **kw),
            N.Conv2d(hidden_dim, oup, 1, use_bias=False, generator=generator, device=device),
            norm_layer(oup, device=device),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv(x)
        return out + x if self.use_res_connect else out


class MobileNetV2(nn.Module):
    def __init__(
        self,
        num_classes: int = 1000,
        width_mult: float = 1.0,
        inverted_residual_setting: Optional[List[List[int]]] = None,
        round_nearest: int = 8,
        dropout: float = 0.2,
        norm_layer: Callable[..., nn.Module] = N.BatchNorm,
        *,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        generator, device = default_generator(generator), resolve_device(device)
        kw = dict(generator=generator, device=device)
        if inverted_residual_setting is None:
            inverted_residual_setting = [  # t, c, n, s
                [1, 16, 1, 1],
                [6, 24, 2, 2],
                [6, 32, 3, 2],
                [6, 64, 4, 2],
                [6, 96, 3, 1],
                [6, 160, 3, 2],
                [6, 320, 1, 1],
            ]
        input_channel = _make_divisible(32 * width_mult, round_nearest)
        self.last_channel = _make_divisible(1280 * max(1.0, width_mult), round_nearest)
        features = [ConvNormActivation(3, input_channel, stride=2, norm_layer=norm_layer,
                                       activation_layer=N.relu6, **kw)]
        for t, c, n, s in inverted_residual_setting:
            output_channel = _make_divisible(c * width_mult, round_nearest)
            for i in range(n):
                features.append(_InvertedResidual(input_channel, output_channel, s if i == 0 else 1, t, norm_layer,
                                                  **kw))
                input_channel = output_channel
        features.append(ConvNormActivation(input_channel, self.last_channel, kernel_size=1, norm_layer=norm_layer,
                                           activation_layer=N.relu6, **kw))
        self.features = nn.Sequential(*features)
        self.classifier = nn.Sequential(N.Dropout(dropout), N.Linear(self.last_channel, num_classes, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, single = ensure_nhwc(x)
        x = self.features(x).mean((1, 2))
        return debatch(self.classifier(x), single)


def mobilenet_v2(torch_weights: Optional[str] = None, **kwargs: Any) -> MobileNetV2:
    return maybe_load_state_dict(MobileNetV2(**kwargs), torch_weights)
