"""DenseNet 121/161/169/201, NHWC batched
(eqxvision_tpu/models/classification/densenet.py).

torchvision's module tree and state-dict names: ``features`` a named
``nn.Sequential`` (``conv0``, ``norm0``, ``relu0``, ``pool0``, then
``denseblock{k}`` and ``transition{k}``, and ``norm5``); a block's layers
``denselayer{j}``, each pre-activation (``norm1``, ``relu1``, ``conv1`` 1x1,
``norm2``, ``relu2``, ``conv2`` 3x3); a transition ``norm``, ``relu``,
``conv`` 1x1 and a 2 x 2 average pool. A block concatenates every earlier
feature map on the channel axis (the last one in NHWC) before each layer,
and once more at the end, as the JAX model does. The BatchNorm of a
layer or a transition comes before its ReLU and conv, so
``ops.fold_batchnorm`` folds only the stem's ``norm0`` into ``conv0``
(ROADMAP C.14). No kernel of the port runs here.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import AvgPool2d, BatchNorm, Conv2d, Linear, MaxPool2d, adaptive_avg_pool2d, flatten_chw
from .._common import debatch, default_generator, ensure_nhwc, maybe_load_state_dict, resolve_device


class _DenseLayer(nn.Module):
    def __init__(self, num_input_features, growth_rate, bn_size, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.norm1 = BatchNorm(num_input_features, device=device)
        self.relu1 = nn.ReLU()
        self.conv1 = Conv2d(num_input_features, bn_size * growth_rate, 1, use_bias=False, **kw)
        self.norm2 = BatchNorm(bn_size * growth_rate, device=device)
        self.relu2 = nn.ReLU()
        self.conv2 = Conv2d(bn_size * growth_rate, growth_rate, 3, padding=1, use_bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(self.relu1(self.norm1(x)))
        return self.conv2(self.relu2(self.norm2(out)))


class _DenseBlock(nn.ModuleDict):
    def __init__(self, num_layers, num_input_features, bn_size, growth_rate, *, generator, device=None):
        super().__init__()
        for i in range(num_layers):
            layer = _DenseLayer(num_input_features + i * growth_rate, growth_rate, bn_size, generator=generator,
                                device=device)
            self.add_module(f"denselayer{i + 1}", layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        features = [x]
        for layer in self.values():
            features.append(layer(torch.cat(features, dim=-1)))
        return torch.cat(features, dim=-1)


class _Transition(nn.Sequential):
    def __init__(self, num_input_features, num_output_features, *, generator, device=None):
        super().__init__(OrderedDict([
            ("norm", BatchNorm(num_input_features, device=device)),
            ("relu", nn.ReLU()),
            ("conv", Conv2d(num_input_features, num_output_features, 1, use_bias=False, generator=generator,
                            device=device)),
            ("pool", AvgPool2d(2, 2)),
        ]))


class DenseNet(nn.Module):
    def __init__(
        self,
        growth_rate: int = 32,
        block_config: Tuple[int, ...] = (6, 12, 24, 16),
        num_init_features: int = 64,
        bn_size: int = 4,
        num_classes: int = 1000,
        *,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        kw = dict(generator=default_generator(generator), device=resolve_device(device))
        device = kw["device"]
        layers = OrderedDict([
            ("conv0", Conv2d(3, num_init_features, 7, stride=2, padding=3, use_bias=False, **kw)),
            ("norm0", BatchNorm(num_init_features, device=device)),
            ("relu0", nn.ReLU()),
            ("pool0", MaxPool2d(3, 2, 1)),
        ])
        num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            layers[f"denseblock{i + 1}"] = _DenseBlock(num_layers, num_features, bn_size, growth_rate, **kw)
            num_features += num_layers * growth_rate
            if i != len(block_config) - 1:
                layers[f"transition{i + 1}"] = _Transition(num_features, num_features // 2, **kw)
                num_features //= 2
        layers["norm5"] = BatchNorm(num_features, device=device)
        self.features = nn.Sequential(layers)
        self.classifier = Linear(num_features, num_classes, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, single = ensure_nhwc(x)
        x = flatten_chw(adaptive_avg_pool2d(F.relu(self.features(x)), (1, 1)))
        return debatch(self.classifier(x), single)


def _densenet(growth_rate, block_config, num_init_features, torch_weights, **kwargs) -> DenseNet:
    return maybe_load_state_dict(DenseNet(growth_rate, block_config, num_init_features, **kwargs), torch_weights)


def densenet121(torch_weights: Optional[str] = None, **kwargs: Any) -> DenseNet:
    return _densenet(32, (6, 12, 24, 16), 64, torch_weights, **kwargs)


def densenet161(torch_weights: Optional[str] = None, **kwargs: Any) -> DenseNet:
    return _densenet(48, (6, 12, 36, 24), 96, torch_weights, **kwargs)


def densenet169(torch_weights: Optional[str] = None, **kwargs: Any) -> DenseNet:
    return _densenet(32, (6, 12, 32, 32), 64, torch_weights, **kwargs)


def densenet201(torch_weights: Optional[str] = None, **kwargs: Any) -> DenseNet:
    return _densenet(32, (6, 12, 48, 32), 64, torch_weights, **kwargs)
