"""Lite R-ASPP on a MobileNetV3-Large trunk
(eqxvision_tpu/models/segmentation/lraspp.py).

The backbone is the trunk's ``features`` behind the getter, tapped at
indices 4 (low, stride 8) and 16 (high, stride 16 with the dilated trunk),
so its state-dict names run ``backbone.0.0.weight`` to ``backbone.16...``.
``LRASPPHead``: ``cbr`` (1x1 conv, BatchNorm, ReLU) times ``scale``
(global average pool, 1x1 conv, sigmoid), resized to the low tap's size
(at 520 px, 33 x 33 to 65 x 65), then ``low_classifier(low) +
high_classifier(x)``. The forward returns the map alone, NHWC at the
input's size. No kernel of the port runs here.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from ... import nn as N
from ...experimental import intermediate_layer_getter
from ..classification.mobilenetv3 import mobilenet_v3_large
from .._common import debatch, default_generator, ensure_nhwc, maybe_load_state_dict, resolve_device
from ._utils import resize_bilinear


class LRASPPHead(nn.Module):
    def __init__(self, low_channels, high_channels, num_classes, inter_channels=128, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.cbr = nn.Sequential(
            N.Conv2d(high_channels, inter_channels, 1, use_bias=False, **kw),
            N.BatchNorm(inter_channels, device=device),
            nn.ReLU(),
        )
        self.scale = nn.Sequential(
            N.AdaptiveAvgPool2d(1),
            N.Conv2d(high_channels, inter_channels, 1, use_bias=False, **kw),
            nn.Sigmoid(),
        )
        self.low_classifier = N.Conv2d(low_channels, num_classes, 1, **kw)
        self.high_classifier = N.Conv2d(inter_channels, num_classes, 1, **kw)

    def forward(self, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
        x = self.cbr(high) * self.scale(high)
        x = resize_bilinear(x, low.shape[1], low.shape[2])
        return self.low_classifier(low) + self.high_classifier(x)


class LRASPP(nn.Module):
    def __init__(self, backbone: nn.Module, low_channels, high_channels, num_classes=21, inter_channels=128, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.backbone = backbone  # an IntermediateLayerGetter tapping [low, high]
        self.classifier = LRASPPHead(low_channels, high_channels, num_classes, inter_channels,
                                     generator=default_generator(generator), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, single = ensure_nhwc(x)
        _, (low, high) = self.backbone(x)
        out = resize_bilinear(self.classifier(low, high), x.shape[1], x.shape[2])
        return debatch(out, single)


def lraspp_mobilenet_v3_large(
    num_classes: Optional[int] = 21,
    backbone: Optional[nn.Module] = None,
    intermediate_layers: Optional[Callable] = None,
    torch_weights: Optional[str] = None,
    *,
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device] = "cuda",
) -> LRASPP:
    """LR-ASPP; the default backbone is a dilated MobileNetV3-Large
    tapped at ``features`` indices [4, 16]."""
    kw = dict(generator=default_generator(generator), device=resolve_device(device))
    num_classes = 21 if num_classes is None else num_classes
    if backbone is None:
        backbone = mobilenet_v3_large(dilated=True, **kw)
    if intermediate_layers is None:
        intermediate_layers = lambda m: [4, 16]  # noqa: E731
    features = backbone.features
    low_channels, high_channels = (features[i].out_channels for i in intermediate_layers(features))
    wrapped = intermediate_layer_getter(features, intermediate_layers)
    return maybe_load_state_dict(LRASPP(wrapped, low_channels, high_channels, num_classes, **kw), torch_weights)
