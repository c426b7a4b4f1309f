"""VGG 11/13/16/19 and their BatchNorm variants, NHWC batched
(eqxvision_tpu/models/classification/vgg.py).

torchvision's module tree and state-dict names: ``features`` a
``nn.Sequential`` of Conv2d, [BatchNorm,] ReLU and 2 x 2 max pools;
``classifier`` Linear-ReLU-Dropout twice, then Linear (``classifier.0``,
``.3``, ``.6``), after an adaptive pool to 7 x 7 and the CHW-ordered
flatten. No kernel of the port runs here.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch
from torch import nn

from ...nn import AdaptiveAvgPool2d, BatchNorm, Conv2d, Dropout, Linear, MaxPool2d, flatten_chw
from .._common import debatch, default_generator, ensure_nhwc, maybe_load_state_dict, resolve_device

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_features(cfg, batch_norm: bool, **kw) -> nn.Sequential:
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2d(2, 2))
            continue
        layers.append(Conv2d(in_channels, v, 3, padding=1, **kw))
        if batch_norm:
            layers.append(BatchNorm(v, device=kw["device"]))
        layers.append(nn.ReLU())
        in_channels = v
    return nn.Sequential(*layers)


class VGG(nn.Module):
    def __init__(
        self, cfg: str = "A", batch_norm: bool = False, num_classes: int = 1000, dropout: float = 0.5, *,
        generator: Optional[torch.Generator] = None, device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        kw = dict(generator=default_generator(generator), device=resolve_device(device))
        self.features = _make_features(_CFGS[cfg], batch_norm, **kw)
        self.avgpool = AdaptiveAvgPool2d((7, 7))
        self.classifier = nn.Sequential(
            Linear(512 * 7 * 7, 4096, **kw),
            nn.ReLU(),
            Dropout(dropout),
            Linear(4096, 4096, **kw),
            nn.ReLU(),
            Dropout(dropout),
            Linear(4096, num_classes, **kw),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, single = ensure_nhwc(x)
        x = flatten_chw(self.avgpool(self.features(x)))
        return debatch(self.classifier(x), single)


def _vgg(cfg, batch_norm, torch_weights, **kwargs) -> VGG:
    return maybe_load_state_dict(VGG(cfg, batch_norm, **kwargs), torch_weights)


def vgg11(torch_weights: Optional[str] = None, **kwargs: Any) -> VGG:
    return _vgg("A", False, torch_weights, **kwargs)


def vgg11_bn(torch_weights: Optional[str] = None, **kwargs: Any) -> VGG:
    return _vgg("A", True, torch_weights, **kwargs)


def vgg13(torch_weights: Optional[str] = None, **kwargs: Any) -> VGG:
    return _vgg("B", False, torch_weights, **kwargs)


def vgg13_bn(torch_weights: Optional[str] = None, **kwargs: Any) -> VGG:
    return _vgg("B", True, torch_weights, **kwargs)


def vgg16(torch_weights: Optional[str] = None, **kwargs: Any) -> VGG:
    return _vgg("D", False, torch_weights, **kwargs)


def vgg16_bn(torch_weights: Optional[str] = None, **kwargs: Any) -> VGG:
    return _vgg("D", True, torch_weights, **kwargs)


def vgg19(torch_weights: Optional[str] = None, **kwargs: Any) -> VGG:
    return _vgg("E", False, torch_weights, **kwargs)


def vgg19_bn(torch_weights: Optional[str] = None, **kwargs: Any) -> VGG:
    return _vgg("E", True, torch_weights, **kwargs)
